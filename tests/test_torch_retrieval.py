"""The port's retrieval metrics (clip_dplm_tpu_torch/train/metrics.py)
against the JAX package's `retrieval_metrics` and
`cosine_similarity_matrix` on the same embeddings, tie-free (continuous
draws), where every metric is a count and must agree exactly (the cosine
matrix within f32 rounding, rtol 1e-5 / atol 1e-6); and
`trainer.evaluate_retrieval` over a model's batches."""

import numpy as np
import pytest
import torch

from clip_dplm_tpu.train import metrics as jax_metrics
from clip_dplm_tpu_torch.config import Config, apply_overrides
from clip_dplm_tpu_torch.experiments.registry import build_model
from clip_dplm_tpu_torch.train import metrics
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.train.trainer import evaluate_retrieval

KEYS = ["R@1_ab", "R@1_ba", "R@1", "R@5_ab", "R@5_ba", "R@5", "R@10_ab", "R@10_ba", "R@10",
        "accuracy", "mean_rank"]


def _pairs(n, d, noise, seed):
    """b = a + noise: positives near the diagonal, not always first."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = (a + noise * rng.normal(size=(n, d))).astype(np.float32)
    return a, b


@pytest.mark.parametrize("n,d,noise", [(64, 16, 0.5), (64, 16, 2.0), (200, 32, 1.5),
                                       (37, 8, 0.0), (12, 128, 5.0)])
def test_retrieval_metrics_match_jax(n, d, noise):
    a, b = _pairs(n, d, noise, seed=n + d)
    want = {k: float(v) for k, v in jax_metrics.retrieval_metrics(a, b).items()}
    got = metrics.retrieval_metrics(torch.from_numpy(a), torch.from_numpy(b))
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in KEYS:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        assert float(got[k]) == pytest.approx(want[k], rel=1e-6, abs=1e-7), k


def test_retrieval_metrics_bounds_and_perfect_pairs():
    a, b = _pairs(50, 16, 0.0, seed=1)
    got = metrics.retrieval_metrics(torch.from_numpy(a), torch.from_numpy(b))
    assert all(float(got[k]) == 1.0 for k in KEYS if k != "mean_rank")
    assert float(got["mean_rank"]) == 0.0
    a, b = _pairs(50, 16, 3.0, seed=2)
    got = {k: float(v) for k, v in metrics.retrieval_metrics(torch.from_numpy(a),
                                                             torch.from_numpy(b)).items()}
    for side in ("_ab", "_ba", ""):
        assert 0.0 <= got["R@1" + side] <= got["R@5" + side] <= got["R@10" + side] <= 1.0


def test_cosine_similarity_matrix_matches_jax():
    a, b = _pairs(20, 24, 1.0, seed=3)
    want = np.asarray(jax_metrics.cosine_similarity_matrix(a, b[:13]))
    got = metrics.cosine_similarity_matrix(torch.from_numpy(a), torch.from_numpy(b[:13]))
    assert got.shape == (20, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_evaluate_retrieval_over_batches():
    """The metrics of the concatenated deterministic embeddings of every
    batch; the model's train/eval mode is restored."""
    cfg = apply_overrides(Config(), ["tower_a.input_dim=12", "tower_b.input_dim=20",
                                     "tower_a.hidden_size=32", "tower_b.hidden_size=32",
                                     "projection.dim=16", "projection.hidden_dim=32"])
    model = build_model(cfg, dtype=torch.float32)
    create_train_state(model, cfg)
    rng = np.random.default_rng(4)
    batches = [{"a": rng.normal(size=(8, 12)).astype(np.float32),
                "b": rng.normal(size=(8, 20)).astype(np.float32)} for _ in range(3)]
    model.train()
    got = evaluate_retrieval(model, batches)
    assert model.training
    with torch.no_grad():
        outs = [model({k: torch.from_numpy(v) for k, v in b.items()}) for b in batches]
    want = metrics.retrieval_metrics(torch.cat([o["emb_a"] for o in outs]),
                                     torch.cat([o["emb_b"] for o in outs]))
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    with pytest.raises(ValueError, match="no batch"):
        evaluate_retrieval(model, [])
