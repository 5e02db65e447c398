"""The port's analysis suite and its CLIs (clip_dplm_tpu_torch:
train/analysis.py with its numpy k-means, experiments/analyze.py,
experiments/visualize.py, experiments/sweep.py, config.py::
create_experiment_configs, utils/system.py, types.py) against the JAX
package, in f32 on the CPU:

- every function of train/analysis.py on seeded numpy inputs: rtol 1e-5,
  exact for the confusion matrix and the failure cases' indices;
- `validate_data`: the same stats and the same raises; the enums: the same
  members and values;
- `kmeans` against `sklearn.cluster.KMeans(n_init=4, random_state=0)` on
  the analyze CLI's inputs (the raw `a` rows of the validation split) and on
  clustered draws with k from 2 to 8: the same partition and the same label
  numbers;
- the analyze CLI: JAX's on a JAX (orbax) checkpoint of a small cached
  two-tower, the port's on the port checkpoint of the same state carried
  across (`load_flax_train_state`), both models built in f32: the same
  report keys, every number within 1e-5 and every class id and index
  equal; both draw their figure by PCA here (t-SNE has no seed in JAX's
  call, so no two runs agree on it);
- the visualize CLI: the same figure names;
- the sweep CLI (`temperature_sweep`, one epoch, tiny widths, dropout 0,
  both trainers from JAX's initial weights): the same variant names, and
  the losses within rtol 1e-4 (the train-step bound of
  test_torch_two_tower.py); `create_experiment_configs` for all four sweeps:
  the same names and the same changed fields.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu import types as jtypes
from clip_dplm_tpu.experiments import analyze as jax_analyze
from clip_dplm_tpu.experiments import registry as jax_registry
from clip_dplm_tpu.experiments import sweep as jax_sweep
from clip_dplm_tpu.experiments import visualize as jax_visualize
from clip_dplm_tpu.models import TwoTowerCLIP as JaxTwoTowerCLIP
from clip_dplm_tpu.train import analysis as jan
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from clip_dplm_tpu.utils import system as jsystem
from clip_dplm_tpu.utils import visualization as jviz
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch import types as ptypes
from clip_dplm_tpu_torch.experiments import analyze as analyze_cli
from clip_dplm_tpu_torch.experiments import registry as port_registry
from clip_dplm_tpu_torch.experiments import sweep as sweep_cli
from clip_dplm_tpu_torch.experiments import visualize as visualize_cli
from clip_dplm_tpu_torch.models.clip import TwoTowerCLIP
from clip_dplm_tpu_torch.train import analysis as pan
from clip_dplm_tpu_torch.train import state as pstate
from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.utils import system as psystem
from clip_dplm_tpu_torch.utils import visualization as pviz
from clip_dplm_tpu_torch.utils.convert import load_flax_params, load_flax_train_state
from clip_dplm_tpu_torch.utils.logging import MetricLogger
from test_torch_esm import rng_params

TINY = ["tower_a.input_dim=24", "tower_a.hidden_size=64", "tower_a.num_hidden_layers=2",
        "tower_b.input_dim=40", "tower_b.hidden_size=64", "tower_b.num_hidden_layers=2",
        "projection.dim=32", "projection.hidden_dim=64", "train.batch_size=64"]
CACHED = TINY + ["contrastive.use_cache=true", "contrastive.cache_size=96"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for these small CPU ops (the suite runs six xdist
    workers on the host's cores; a probe's 80 steps took 2x as long on
    eight threads as on one, alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emb(seed=0, n=48, d=12, k=4):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = (a + 0.7 * rng.normal(size=(n, d))).astype(np.float32)
    return a, b, rng.integers(0, k, n).astype(np.int32)


def _close(got, want, path="report"):
    """Nested reports equal: the same keys, ints equal, floats within 1e-5."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, list(got), list(want))
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, (int, np.integer)) and not isinstance(want, bool):
        assert int(got) == int(want), (path, got, want)
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5, err_msg=path)


def test_confusion_and_failure_cases_match_jax():
    a, b, labels = _emb()
    cm = pan.compute_confusion_matrix(a, b, labels, 4)
    np.testing.assert_array_equal(cm, jan.compute_confusion_matrix(a, b, labels, 4))
    assert cm.sum() == 48
    _close(pan.analyze_cell_type_confusion(cm), jan.analyze_cell_type_confusion(cm))
    names = ["T", "B", "NK", "Mono"]
    assert (pan.analyze_cell_type_confusion(cm, names)
            == jan.analyze_cell_type_confusion(cm, names))
    got, want = pan.analyze_failure_cases(a, b, top_k=7), jan.analyze_failure_cases(a, b, top_k=7)
    assert [c["index"] for c in got] == [c["index"] for c in want]
    _close(got, want)


def test_collapse_marker_space_distributions_and_cache_stats_match_jax():
    a, b, labels = _emb(1)
    spaces = {"tower_a": a, "tower_b": b}
    _close(pan.analyze_embedding_collapse(spaces, labels),
           jan.analyze_embedding_collapse(spaces, labels))
    markers = np.random.default_rng(2).normal(size=(48, 30)).astype(np.float32)
    _close(pan.marker_space_analysis(markers, a), jan.marker_space_analysis(markers, a))
    _close(pan.analyze_embedding_distributions(spaces, 5),
           jan.analyze_embedding_distributions(spaces, 5))
    cache = np.concatenate([b[:5], np.random.default_rng(3).normal(size=(20, 12))]).astype(
        np.float32)
    for n in (0, 3, 25):
        _close(pan.hard_negative_cache_stats(a, b, cache, n),
               jan.hard_negative_cache_stats(a, b, cache, n))


def test_cross_dataset_and_the_dynamics_tracker_match_jax():
    sets = {name: _emb(s)[:2] for s, name in enumerate(("immgen", "hca"))}
    _close(pan.cross_dataset_analysis(lambda x, y: (x, y), sets),
           jan.cross_dataset_analysis(lambda x, y: (x, y), sets))
    pt, jt = pan.TrainingDynamicsTracker(window=3), jan.TrainingDynamicsTracker(window=3)
    for v in (3.0, 2.0, 1.0, 1.5, 0.5):
        _close(pt.update({"loss": v, "acc": 1 / v}), jt.update({"loss": v, "acc": 1 / v}))
        assert pt.best == jt.best and pt.steps_since_best == jt.steps_since_best
        assert pt.improved("loss") == jt.improved("loss")


def test_validate_data_and_enums_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(30, 6)).astype(np.float32)
    x[:, 2] = 1.0  # a dead feature
    for kw in ({}, {"min_variance": 1e-3}, {"min_value": -10, "max_value": 10}):
        assert psystem.validate_data(x, **kw) == jsystem.validate_data(x, **kw)
    bad = x.copy()
    bad[0, 0] = np.nan
    cases = [(bad, {}), (x, {"min_value": 0.0}), (x, {"max_value": 0.5}),
             (np.ones((4, 3)), {"min_variance": 1.0})]
    for arr, kw in cases:
        with pytest.raises(jsystem.DataValidationError) as want:
            jsystem.validate_data(arr, name="x", **kw)
        with pytest.raises(psystem.DataValidationError, match="x: ") as got:
            psystem.validate_data(arr, name="x", **kw)
        assert str(got.value) == str(want.value)
    stats = psystem.validate_data(bad, max_missing_fraction=0.1)
    assert stats == jsystem.validate_data(bad, max_missing_fraction=0.1)
    for name in ("BiologicalDataType", "BiologicalScale"):
        assert ([(m.name, m.value) for m in getattr(ptypes, name)]
                == [(m.name, m.value) for m in getattr(jtypes, name)])
    assert psystem.get_memory_status() == {}  # no card here


def _sklearn(x, k):
    return KMeans(n_clusters=k, n_init=4, random_state=0).fit(x)


@pytest.mark.parametrize("k", range(2, 9))
def test_kmeans_matches_sklearn(k):
    """Clustered draws (every third k: no structure at all): the same
    partition, the same label numbers, the same inertia (rtol 1e-5)."""
    rng = np.random.default_rng(10 + k)
    n, d = 150 + 20 * k, 6 + 3 * k
    centers = 3 * rng.normal(size=(k, d))
    x = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    x = (rng.normal(size=(n, d)) if k % 3 == 0 else x).astype(np.float32)
    want = _sklearn(x, k)
    labels, centers, inertia = pan.kmeans(x, k, n_init=4, random_state=0)
    assert labels.shape == (n,) and centers.shape == (k, d)
    assert pan._same_clustering(labels, want.labels_, k)
    assert pan._same_clustering(want.labels_, labels, k)
    np.testing.assert_array_equal(labels, want.labels_)
    np.testing.assert_allclose(inertia, want.inertia_, rtol=1e-5)
    np.testing.assert_allclose(centers, want.cluster_centers_, rtol=1e-4, atol=1e-5)


def test_kmeans_matches_sklearn_on_the_analyze_inputs():
    """The analyze CLI's call: the raw `a` rows of the validation split of
    the synthetic two-tower data, k = min(8, max(2, n // 32))."""
    _, val = port_registry.build_data(pconfig.apply_overrides(pconfig.Config(), TINY))
    raw = np.concatenate([b["a"] for b in val()])
    k = min(8, max(2, raw.shape[0] // 32))
    assert (raw.shape, k) == ((256, 24), 8)
    np.testing.assert_array_equal(pan.kmeans(raw, k)[0], _sklearn(raw, k).labels_)


@pytest.fixture
def f32_builders(monkeypatch):
    """Both packages' two-tower built with f32 compute, and both
    Visualizers' embedding scatter by PCA."""
    monkeypatch.setattr(jax_registry, "build_model",
                        lambda cfg: JaxTwoTowerCLIP(cfg=cfg, dtype=jnp.float32))
    monkeypatch.setattr(port_registry, "build_model",
                        lambda cfg, device=None, dtype=None: TwoTowerCLIP(
                            cfg, dtype=torch.float32, device=device))
    for viz in (jviz.Visualizer, pviz.Visualizer):
        plot = viz.plot_embeddings
        monkeypatch.setattr(viz, "plot_embeddings",
                            lambda self, *a, _plot=plot, **kw: _plot(self, *a, **{
                                **kw, "method": "pca"}))


def _checkpoints(tmp_path, over):
    """A JAX checkpoint of a small cached two-tower with random weights and
    a partly filled cache (70 of 96 rows), and the port checkpoint of the
    same state."""
    jcfg = jconfig.apply_overrides(jconfig.Config(), over)
    pcfg = pconfig.apply_overrides(pconfig.Config(), over)
    jm = JaxTwoTowerCLIP(cfg=jcfg, dtype=jnp.float32)
    _, val = jax_registry.build_data(jcfg)
    js = jax_create_train_state(jm, jcfg, jax.tree_util.tree_map(jnp.asarray, next(iter(val()))))
    params = rng_params(js.params, np.random.default_rng(3))
    rows = np.random.default_rng(4).normal(size=(96, 32)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows[70:] = 0.0
    js = js.replace(params=params, opt_state=js.tx.init(params), cache=jnp.asarray(rows),
                    cache_ptr=jnp.int32(70), cache_len=jnp.int32(70))
    JaxCheckpointManager(str(tmp_path / "jax_ckpt")).save(js, 0)
    pst = create_train_state(TwoTowerCLIP(pcfg, dtype=torch.float32), pcfg, init=False)
    CheckpointManager(str(tmp_path / "port_ckpt")).save(load_flax_train_state(pst, js), 0)


def test_analyze_cli_matches_jax(tmp_path, f32_builders, capsys):
    _checkpoints(tmp_path, CACHED)
    runs = {}
    for name, main, extra in (("jax", jax_analyze.main, []),
                              ("port", analyze_cli.main, ["--device", "cpu"])):
        over = [a for o in CACHED + [f"logging.log_dir={tmp_path / name}"] for a in ("-o", o)]
        runs[name] = main(["--checkpoint", str(tmp_path / f"{name}_ckpt"), *over,
                           "--out", str(tmp_path / f"{name}.json"), *extra])
        assert os.path.exists(tmp_path / name / "figures" / "analysis_embeddings.png")
    want, got = runs["jax"], runs["port"]
    assert list(got) == ["retrieval", "cache_stats", "distributions", "failure_cases",
                         "marker_space", "class_confusion", "embedding_collapse"]
    assert got["cache_stats"]["cache_hit_rate"] > 0
    assert np.asarray(got["class_confusion"]["matrix"]).shape == (8, 8)
    _close(got, want)
    import json

    with open(tmp_path / "port.json") as f:
        _close(json.load(f), want)
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith('{"R@1"')]
    assert len(lines) == 2 and json.loads(lines[1])["report"] == str(tmp_path / "port.json")


def test_analyze_without_the_plotting_packages_writes_the_report(tmp_path, monkeypatch):
    _checkpoints(tmp_path, CACHED)
    monkeypatch.setattr(pviz, "missing", lambda *m: ["scikit-learn"])
    over = [a for o in CACHED + [f"logging.log_dir={tmp_path / 'run'}"] for a in ("-o", o)]
    with pytest.warns(UserWarning, match="scikit-learn not installed"):
        report = analyze_cli.main(["--checkpoint", str(tmp_path / "port_ckpt"), *over,
                                   "--device", "cpu"])
    assert os.path.exists(tmp_path / "run" / "analysis.json") and "retrieval" in report
    assert not os.path.exists(tmp_path / "run" / "figures")
    with pytest.raises(SystemExit, match="scikit-learn"):
        visualize_cli.main(["--checkpoint", str(tmp_path / "port_ckpt"), *over,
                            "--device", "cpu"])


def test_visualize_cli_writes_jaxs_figures(tmp_path, f32_builders):
    _checkpoints(tmp_path, CACHED)
    figures = {}
    for name, main, extra in (("jax", jax_visualize.main, []),
                              ("port", visualize_cli.main, ["--device", "cpu"])):
        log_dir = tmp_path / name
        logger = MetricLogger(str(log_dir))
        for epoch in range(3):
            logger.log(epoch, {"train_loss": 3.0 - epoch, "val_loss": 3.2 - epoch})
        logger.close()
        over = [a for o in CACHED + [f"logging.log_dir={log_dir}"] for a in ("-o", o)]
        figures[name] = main(["--checkpoint", str(tmp_path / f"{name}_ckpt"), *over, *extra])
        assert all(os.path.getsize(p) > 0 for p in figures[name])
    assert ([os.path.relpath(p, tmp_path / "port") for p in figures["port"]]
            == [os.path.relpath(p, tmp_path / "jax") for p in figures["jax"]]
            == ["figures/embeddings.png", "figures/similarity.png", "figures/training.png"])


def _changes(base, cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(base):
        a, b = getattr(base, f.name), getattr(cfg, f.name)
        if dataclasses.is_dataclass(a):
            out.update(_changes(a, b, f"{prefix}{f.name}."))
        elif a != b:
            out[f"{prefix}{f.name}"] = b
    return out


@pytest.mark.parametrize("sweep", ["embedding_sweep", "architecture_search", "training_sweep",
                                   "temperature_sweep"])
def test_create_experiment_configs_matches_jax(sweep):
    jbase, pbase = jconfig.Config(), pconfig.Config()
    want = jconfig.create_experiment_configs(jbase, sweep)
    got = pconfig.create_experiment_configs(pbase, sweep)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, p), (_, j) in zip(got, want):
        assert _changes(pbase, p) == _changes(jbase, j), name
    with pytest.raises(ValueError, match="unknown sweep"):
        pconfig.create_experiment_configs(pbase, "no_such_sweep")


SWEEP = TINY + ["projection.dropout=0.0", "train.batch_size=256"]


def test_sweep_cli_matches_jax(tmp_path, f32_builders, monkeypatch):
    """Both trainers start from JAX's initial weights (the temperature
    variants share them) and run the same batches."""
    jcfg = jconfig.apply_overrides(jconfig.Config(), SWEEP)
    train, _ = jax_registry.build_data(jcfg)
    init = jax_create_train_state(JaxTwoTowerCLIP(cfg=jcfg, dtype=jnp.float32), jcfg,
                                  jax.tree_util.tree_map(jnp.asarray, next(iter(train())))).params
    made = pstate.create_train_state

    def from_jax_init(model, cfg, *a, **kw):
        load_flax_params(model, init)
        return made(model, cfg, *a, **{**kw, "init": False})

    monkeypatch.setattr(pstate, "create_train_state", from_jax_init)
    results = {}
    for name, main, extra in (("jax", jax_sweep.main, []),
                              ("port", sweep_cli.main, ["--device", "cpu"])):
        over = [a for o in SWEEP + [f"logging.log_dir={tmp_path / name}"] for a in ("-o", o)]
        results[name] = main(["--sweep", "temperature_sweep", "--epochs", "1", *over, *extra])
        with open(tmp_path / name / "sweep_temperature_sweep.csv") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["variant", "best_val_loss", "final_train_loss"] and len(rows) == 5
    want, got = results["jax"], results["port"]
    assert list(got) == list(want) == ["temp_0.05", "temp_0.07", "temp_0.1", "temp_0.2"]
    for name in want:
        assert set(got[name]) == set(want[name])
        for k in want[name]:
            assert np.isfinite(got[name][k])
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=1e-4,
                                       err_msg=f"{name} {k}")
