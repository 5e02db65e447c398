"""The port's evaluate CLI and its metrics (clip_dplm_tpu_torch:
experiments/evaluate.py; train/metrics.py `BiologicalMetrics`,
`embedding_collapse`, `confusion_matrix`) against the JAX package.

- The metrics on seeded numpy inputs against JAX's: rtol 1e-5 in f32
  (BiologicalMetrics with and without labels, embedding_collapse), exact
  for the confusion matrix.
- The evaluate CLI against JAX's on one small two-tower state: JAX's
  `evaluate.main` reads a JAX checkpoint of it, the port's reads the port
  checkpoint of the same state carried across with `load_flax_train_state`;
  the same overrides and the same validation split. Both packages' model
  builders are pinned to f32 compute (XLA's and PyTorch's bf16 roundings
  differ): the two eval_metrics.csv files have the same rows, every value
  within 1e-5 and the R@k values equal; --save-embeddings writes the same
  keys, the embeddings within 1e-5.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.experiments import evaluate as jax_evaluate
from clip_dplm_tpu.experiments import registry as jax_registry
from clip_dplm_tpu.models import TwoTowerCLIP as JaxTwoTowerCLIP
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import metrics as jmetrics
from clip_dplm_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.experiments import evaluate as evaluate_cli
from clip_dplm_tpu_torch.experiments import registry as port_registry
from clip_dplm_tpu_torch.models.clip import TwoTowerCLIP
from clip_dplm_tpu_torch.train import metrics as pmetrics
from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.utils.convert import load_flax_train_state
from test_torch_esm import rng_params

EVAL = ["tower_a.input_dim=24", "tower_a.hidden_size=64", "tower_a.num_hidden_layers=2",
        "tower_b.input_dim=40", "tower_b.hidden_size=64", "tower_b.num_hidden_layers=2",
        "projection.dim=32", "projection.hidden_dim=64", "train.batch_size=64"]


def _embeddings(n=96, d=16, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = (a + 0.8 * rng.normal(size=(n, d))).astype(np.float32)
    return a, b, rng.integers(0, 5, size=n).astype(np.int32)


@pytest.mark.parametrize("with_labels", [False, True])
def test_biological_metrics_match_jax(with_labels):
    a, b, labels = _embeddings()
    labels = labels if with_labels else None
    want = jmetrics.BiologicalMetrics().compute_all_metrics(a, b, labels)
    got = pmetrics.BiologicalMetrics().compute_all_metrics(a, b, labels)
    assert got.keys() == want.keys()
    assert ("embedding_collapse_a" in got) == with_labels
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # tensors on their device give the same
    again = pmetrics.BiologicalMetrics().compute_all_metrics(
        torch.from_numpy(a), torch.from_numpy(b),
        None if labels is None else torch.from_numpy(labels))
    assert again == got


def test_embedding_collapse_matches_jax():
    a, _, labels = _embeddings(seed=1)
    want = float(jmetrics.embedding_collapse(jnp.asarray(a), jnp.asarray(labels)))
    got = float(pmetrics.embedding_collapse(torch.from_numpy(a), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    distinct = torch.arange(8)  # no two rows share a label: 0, as JAX
    assert float(pmetrics.embedding_collapse(torch.from_numpy(a[:8]), distinct)) == 0.0


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(2)
    true = rng.integers(0, 7, size=500).astype(np.int32)
    pred = np.where(rng.random(500) < 0.6, true, rng.integers(0, 7, size=500)).astype(np.int32)
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(true), 7))
    got = pmetrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(true), 7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == 500


@pytest.fixture
def f32_builders(monkeypatch):
    """Both packages' two-tower built with f32 compute."""
    monkeypatch.setattr(jax_registry, "build_model",
                        lambda cfg: JaxTwoTowerCLIP(cfg=cfg, dtype=jnp.float32))
    monkeypatch.setattr(port_registry, "build_model",
                        lambda cfg, device=None, dtype=None: TwoTowerCLIP(
                            cfg, dtype=torch.float32, device=device))


def _rows(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["metric", "value"]
    return {k: float(v) for k, v in rows[1:]}


def test_evaluate_cli_matches_jax(tmp_path, f32_builders):
    jcfg = jconfig.apply_overrides(jconfig.Config(), EVAL)
    pcfg = pconfig.apply_overrides(pconfig.Config(), EVAL)
    jm = JaxTwoTowerCLIP(cfg=jcfg, dtype=jnp.float32)
    _, val = jax_registry.build_data(jcfg)
    js = jax_create_train_state(jm, jcfg, jax.tree_util.tree_map(jnp.asarray, next(iter(val()))))
    params = rng_params(js.params, np.random.default_rng(3))
    js = js.replace(params=params, opt_state=js.tx.init(params))
    JaxCheckpointManager(str(tmp_path / "jax_ckpt")).save(js, 0)
    pst = create_train_state(TwoTowerCLIP(pcfg, dtype=torch.float32), pcfg, init=False)
    CheckpointManager(str(tmp_path / "port_ckpt")).save(load_flax_train_state(pst, js), 0)

    over = [a for o in EVAL for a in ("-o", o)]
    want = jax_evaluate.main(["--checkpoint", str(tmp_path / "jax_ckpt"), *over,
                              "--output", str(tmp_path / "jax.csv"),
                              "--save-embeddings", str(tmp_path / "jax.npz")])
    got = evaluate_cli.main(["--checkpoint", str(tmp_path / "port_ckpt"), *over,
                             "--output", str(tmp_path / "port.csv"),
                             "--save-embeddings", str(tmp_path / "port.npz"),
                             "--device", "cpu"])
    jrows, prows = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "port.csv")
    assert prows.keys() == jrows.keys() == got.keys() == want.keys()
    assert {"R@1_mean", "R@1_std", "full_R@10", "full_mean_rank"} <= prows.keys()
    assert prows["full_R@10"] > 0  # random weights, but not collapsed ones
    for k in jrows:
        if "R@" in k:
            assert prows[k] == jrows[k], k
        np.testing.assert_allclose(prows[k], jrows[k], rtol=0, atol=1e-5, err_msg=k)
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert zp.files == zj.files == ["emb_a", "emb_b"]
        assert zp["emb_a"].shape == (256, 32)  # 307 validation pairs: 4 batches of 64
        for k in zj.files:
            np.testing.assert_allclose(zp[k], zj[k], rtol=0, atol=1e-5, err_msg=k)


def test_evaluate_cli_defaults_to_the_card(monkeypatch, tmp_path):
    assert evaluate_cli.parse_args(["--checkpoint", "x"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        evaluate_cli.main(["--checkpoint", str(tmp_path)])
