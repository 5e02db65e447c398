"""The port's host data path (clip_dplm_tpu_torch: data/prefetch.py,
native/, data/collate.py's `nan_padded_to_masked` and `cluster_split`,
utils/precision.py, and the config fields this slice ports) against the JAX
package on numpy inputs from a seed.

The prefetcher passes the four cases of tests/test_prefetch.py (the sentinel
survives a full queue, close() unblocks the worker, an abandoned iterator is
reaped, a worker error is raised in the consumer) and keeps the batch order,
on the CPU (CUDA streams and pinned copies run on the card: chip_smoke.py
phase 20(a)). The native tokenizer and collator equal JAX's Python
`tokenize_batch` and `pad_token_batch` exactly (plain, `replace_uzob`,
truncation, `pad_multiple`), and the C source is JAX's, byte for byte but for
its header comment. `nan_padded_to_masked` is equal exactly, `cluster_split`
gives JAX's train and validation rows (scikit-learn's KMeans there, the
port's numpy k-means here) for k = 4 and 20, and `Policy.cast_to_compute`
gives JAX's dtypes and values on a nested tree."""

import gc
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.data import collate as jcollate
from clip_dplm_tpu.data import protein as jprotein
from clip_dplm_tpu.utils import precision as jprecision
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.data import collate
from clip_dplm_tpu_torch.data.prefetch import DevicePrefetcher, prefetch_to_device
from clip_dplm_tpu_torch.native import bindings, pad_embedding_batch_native, tokenize_batch_native
from clip_dplm_tpu_torch.utils import precision, pretrained

# ---------------------------------------------------------------------------
# data/prefetch.py
# ---------------------------------------------------------------------------


def test_sentinel_survives_full_queue():
    """The DONE sentinel reaches the consumer even when the queue is full
    as the source runs out."""
    batches = [{"x": np.full(2, i, np.float32)} for i in range(4)]
    pf = DevicePrefetcher(iter(batches), depth=1)
    time.sleep(0.3)  # the worker fills the depth-1 queue and runs out
    out = list(pf)
    assert len(out) == 4
    np.testing.assert_array_equal(out[3]["x"].numpy(), batches[3]["x"])


def test_close_unblocks_worker_thread():
    pf = DevicePrefetcher(({"x": np.zeros(1, np.float32)} for _ in range(1000)), depth=1)
    next(pf)
    pf.close()
    pf._thread.join(timeout=2.0)
    assert not pf._thread.is_alive()


def test_abandoned_iterator_reaps_worker():
    """Dropped without close(): the weakref finalizer stops the worker,
    which holds no reference to the prefetcher."""
    pf = DevicePrefetcher(({"x": np.zeros(1, np.float32)} for _ in range(1000)), depth=1)
    next(pf)
    thread = pf._thread
    del pf
    gc.collect()
    thread.join(timeout=2.0)
    assert not thread.is_alive()


def test_worker_error_raised_in_consumer():
    def gen():
        yield {"x": np.zeros(1, np.float32)}
        raise RuntimeError("boom")

    pf = DevicePrefetcher(gen(), depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="boom"):
        for _ in pf:
            pass


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_keeps_order_types_and_ints(depth):
    """Batches arrive in order as CPU tensors of their numpy dtypes (bool
    masks stay bool, a non-contiguous array is copied), a plain int stays
    an int, and `transform` runs on the worker first."""
    rng = np.random.default_rng(depth)
    batches = [{"x": rng.normal(size=(3, 4)).astype(np.float32), "m": rng.random((3,)) > 0.5,
                "t": rng.integers(0, 9, (4, 3)).astype(np.int32).T, "n": i}
               for i in range(7)]
    out = list(prefetch_to_device(iter(batches), "cpu", depth=depth))
    assert [b["n"] for b in out] == list(range(7))
    for got, want in zip(out, batches):
        assert got["x"].dtype == torch.float32 and got["m"].dtype == torch.bool
        assert got["t"].dtype == torch.int32 and isinstance(got["n"], int)
        for k in ("x", "m", "t"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    doubled = list(DevicePrefetcher(iter(batches[:2]), transform=lambda b: {"x": 2 * b["x"]}))
    np.testing.assert_array_equal(doubled[1]["x"].numpy(), 2 * batches[1]["x"])


def test_prefetch_counts_its_wait():
    def slow():
        for i in range(3):
            time.sleep(0.05)
            yield {"x": np.zeros(1, np.float32)}

    pf = DevicePrefetcher(slow())
    assert len(list(pf)) == 3 and pf.wait_seconds > 0.05


# ---------------------------------------------------------------------------
# native/
# ---------------------------------------------------------------------------

SEQS = ["MKTAYIAKQRQISFVKSHFSRQ", "acd efg\nhik", "BUZOXBUZOX" * 3, "L", "MK*#?LL",
        "GSHMA" * 13]


@pytest.mark.parametrize("kw", [{}, {"replace_uzob": True}, {"max_len": 16},
                                {"max_len": 16, "replace_uzob": True}, {"pad_multiple": 1},
                                {"pad_multiple": 32}, {"max_len": 70, "pad_multiple": 16}])
def test_tokenize_batch_native_matches_jax(kw):
    got = tokenize_batch_native(SEQS, **kw)
    want = jprotein.tokenize_batch(SEQS, **kw)
    assert got[0].dtype == want[0].dtype == np.int32 and got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kw", [{}, {"max_len": 12}, {"pad_multiple": 1},
                                {"max_len": 30, "pad_multiple": 16}])
def test_pad_embedding_batch_native_matches_jax(kw):
    rng = np.random.default_rng(4)
    seqs = [rng.normal(size=(n, 6)).astype(np.float32) for n in (3, 17, 9, 25)]
    got = pad_embedding_batch_native(seqs, **kw)
    want = jcollate.pad_token_batch(seqs, **kw)
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_native_library_is_built_from_the_port_source():
    """The C source is the JAX package's but for its header comment; the
    library sits under build/ named by the source's hash."""
    import os

    import clip_dplm_tpu

    jsrc = os.path.join(os.path.dirname(clip_dplm_tpu.__file__), "native", "tokenizer.cpp")
    body = lambda text: text[text.index("#include"):]  # noqa: E731
    with open(jsrc) as f:
        assert body(bindings.SOURCE.read_text()) == body(f.read())
    path = bindings.build()
    assert path == bindings.library_path() and path.exists()
    assert path.parent.parts[-2:] == ("build", "clip_dplm_tpu_torch")
    assert bindings.available()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bindings, "SOURCE", bad)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        bindings.build()


# ---------------------------------------------------------------------------
# data/collate.py
# ---------------------------------------------------------------------------


def test_nan_padded_to_masked_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 9, 5)).astype(np.float32)
    x[0, 6:] = np.nan
    x[2, 1:] = np.nan
    x[3, 4, 2] = np.nan  # one NaN feature masks its token
    got, want = collate.nan_padded_to_masked(x), jcollate.nan_padded_to_masked(x)
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype == bool
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("k", [4, 20])
def test_cluster_split_matches_jax(k):
    ds = collate.TokenPairDataset.synthetic(150, dim_a=12, dim_b=16, latent_dim=6, seed=3)
    got = collate.cluster_split(ds.seqs_a, ds.seqs_b, val_fraction=0.2, n_clusters=k, seed=1)
    want = jcollate.cluster_split(ds.seqs_a, ds.seqs_b, val_fraction=0.2, n_clusters=k, seed=1)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        for a, b in zip(g.seqs_a + g.seqs_b, w.seqs_a + w.seqs_b):
            assert a is b or np.array_equal(a, b)
    assert len(got[0]) + len(got[1]) == 150


# ---------------------------------------------------------------------------
# utils/precision.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["FP32", "BF16"])
def test_cast_to_compute_matches_jax(name):
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.integers(0, 5, (2,)).astype(np.int32), rng.random(3) > 0.5],
            "c": (rng.normal(size=(2,)).astype(np.float16), {"d": np.float32(1.5)})}
    to_torch = lambda t: torch.from_numpy(np.asarray(t))  # noqa: E731
    ptree = {"a": to_torch(tree["a"]), "b": [to_torch(x) for x in tree["b"]],
             "c": (to_torch(tree["c"][0]), {"d": to_torch(tree["c"][1]["d"]), "s": "keep"})}
    jtree = {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(x) for x in tree["b"]],
             "c": (jnp.asarray(tree["c"][0]), {"d": jnp.asarray(tree["c"][1]["d"])})}
    got = getattr(precision, name).cast_to_compute(ptree)
    want = getattr(jprecision, name).cast_to_compute(jtree)
    assert isinstance(got["b"], list) and isinstance(got["c"], tuple) and got["c"][1]["s"] == "keep"
    pairs = [(got["a"], want["a"]), (got["b"][0], want["b"][0]), (got["b"][1], want["b"][1]),
             (got["c"][0], want["c"][0]), (got["c"][1]["d"], want["c"][1]["d"])]
    for g, w in pairs:
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy() if g.is_floating_point() else g.numpy(),
                                      np.asarray(w, np.float32) if g.is_floating_point()
                                      else np.asarray(w))
    assert precision.DTYPES.keys() == jprecision.DTYPES.keys()
    from clip_dplm_tpu_torch.utils import Policy

    assert Policy is precision.Policy and Policy().compute == torch.bfloat16


# ---------------------------------------------------------------------------
# the config fields of this slice
# ---------------------------------------------------------------------------


def test_ported_fields_default_as_jax_and_leave_unported():
    """`precision.remat`, `train.steps_per_call` and `train.optim.fused_update`
    have JAX's defaults and are read from a JAX-written config; the fields
    JAX reads nowhere (`compute_dtype`, `param_dtype`, `num_workers`) stay in
    `_UNPORTED`, and a value off their default raises naming why."""
    got, want = pconfig.Config(), jconfig.Config()
    assert got.precision.remat is want.precision.remat is False
    assert got.train.steps_per_call == want.train.steps_per_call == 1
    assert got.train.optim.fused_update is want.train.optim.fused_update is True
    un = pretrained._UNPORTED
    assert "steps_per_call" not in un["train"] and "optim" not in un["train"]
    assert un["precision"] == {"compute_dtype": "bfloat16", "param_dtype": "float32"}
    assert un["data"]["num_workers"] == 0
    raw = pretrained.config_to_dict(pconfig.apply_overrides(pconfig.Config(), [
        "precision.remat=true", "train.steps_per_call=3", "train.optim.fused_update=false"]))
    cfg = pretrained.config_from_dict(raw)
    assert (cfg.precision.remat, cfg.train.steps_per_call, cfg.train.optim.fused_update) == (
        True, 3, False)
    for field, value in (("compute_dtype", "float32"), ("param_dtype", "bfloat16")):
        with pytest.raises(ValueError, match=f"precision.{field}.*nothing of the JAX package"):
            pretrained.config_from_dict({"precision": {field: value}})
    with pytest.raises(ValueError, match="data.num_workers"):
        pretrained.config_from_dict({"data": {"num_workers": 4}})
