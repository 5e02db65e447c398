"""DPLM training in the port (experiment=dplm: models/dplm.py's corruption,
diffusion loss and ESM-2 warm start; the dplm loss and eval steps of
train/trainer.py; the registry's data; the train CLI; the bench's step
count) against the JAX package on the same numpy weights, at a small size
(2 layers, d=64, 2 heads), f32:

- `corrupt`'s invariants (specials and padding never corrupted, t in
  [0.05, 1), a function of the seeds);
- the diffusion loss, its metrics and every leaf's gradient against JAX's
  `diffusion_loss_from_apply` fed the same (x_t, corrupted, t) draw, at S =
  20 (plain attention), 64 (the packed short-S path) and 300 (flash): loss
  rtol 1e-4, gradients 1e-4 of each leaf's largest entry;
- three train steps against JAX's `make_train_step` with experiment=dplm,
  JAX's `corrupt` replaced by the port's draw of each step (loss rtol 1e-4,
  metrics), and the eval step likewise, deterministic and leaving the state
  as it was;
- the registry's batches equal to JAX's, `init_dplm_from_esm` equal to
  JAX's after conversion, one CPU epoch of the train CLI, the bench's FLOP
  count.

JAX on the CPU computes its attention exactly (XLA, no kernel), so the
port's packed attention is pinned to its recompute mode here; the saved mode
has tests/test_torch_saved_probs.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.config import ESMConfig as JaxESMConfig
from clip_dplm_tpu.models import dplm as jax_dplm
from clip_dplm_tpu.models.esm import ESMTower as JaxESMTower
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train.trainer import make_eval_step as jax_make_eval_step
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.config import ESMConfig
from clip_dplm_tpu_torch.experiments import bench
from clip_dplm_tpu_torch.experiments import train as train_cli
from clip_dplm_tpu_torch.experiments.registry import build_data, build_model, motif_proteins
from clip_dplm_tpu_torch.models import dplm
from clip_dplm_tpu_torch.models.esm import ESMTower
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.train.trainer import make_eval_step, make_train_step, to_device
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params
from test_torch_esm import rng_params

SAVES_PROBS = sa.saves_probs  # the rule, before the fixture below pins it
SMALL = ["experiment=dplm", "dplm.d_model=64", "dplm.num_layers=2", "dplm.num_heads=2",
         "train.batch_size=8", "train.optim.schedule=constant",
         "train.optim.learning_rate=1e-3"]


@pytest.fixture(autouse=True)
def recompute_mode(monkeypatch):
    """The packed attention's backward recomputes the probabilities in f32."""
    monkeypatch.setattr(sa, "saves_probs", lambda *a: False)


def _cfgs(extra=(), max_len=512):
    over = SMALL + [f"dplm.max_len={max_len}", *extra]
    return (jconfig.apply_overrides(jconfig.Config(), over),
            pconfig.apply_overrides(pconfig.Config(), over))


def _pair(rng, max_len=512):
    """JAX DPLM (f32) with numpy weights and the port's DPLM carrying them."""
    jcfg, pcfg = _cfgs(max_len=max_len)
    jm = jax_dplm.DPLM(cfg=jcfg.dplm, dtype=jnp.float32)
    params = rng_params(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"],
                        rng)
    port = load_flax_params(build_model(pcfg, dtype=torch.float32), params)
    return jcfg, pcfg, jm, params, port


def _tokens(n, S, seed=0):
    tokens = motif_proteins(np.random.default_rng(seed), n, S)
    return {"tokens": tokens, "mask": tokens != dplm.PAD_IDX}


def _patch_jax_corrupt(monkeypatch, draws):
    """JAX's `corrupt` returns the given draws, one a call, in order."""
    it = iter(draws)

    def fake(key, tokens, valid, t=None):
        x_t, corrupted, t = next(it)
        return jnp.asarray(x_t.numpy()), jnp.asarray(corrupted.numpy()), jnp.asarray(t.numpy())

    monkeypatch.setattr(jax_dplm, "corrupt", fake)


def test_corrupt_invariants():
    b = _tokens(64, 64)
    tokens, valid = torch.from_numpy(b["tokens"]), torch.from_numpy(b["mask"])
    x_t, corrupted, t = dplm.corrupt(DropoutSeeds(5, 3), tokens, valid)
    special = (tokens == dplm.CLS_IDX) | (tokens == dplm.EOS_IDX) | ~valid
    assert not corrupted[special].any()
    assert torch.equal(x_t[special], tokens[special])
    assert (x_t[corrupted] == dplm.MASK_IDX).all() and torch.equal(x_t[~corrupted],
                                                                    tokens[~corrupted])
    assert t.dtype == torch.float32 and t.shape == (64,)
    assert (t >= 0.05).all() and (t < 1.0).all()
    frac = corrupted.sum(1).float() / (valid & ~special).sum(1).float()
    assert abs(float((frac - t).mean())) < 0.05  # a t-fraction of each row
    again = dplm.corrupt(DropoutSeeds(5, 3), tokens, valid)
    other = dplm.corrupt(DropoutSeeds(5, 4), tokens, valid)
    assert all(torch.equal(a, b) for a, b in zip(again, (x_t, corrupted, t)))
    assert not torch.equal(other[2], t)
    # the hash's extremes: t stays below 1, u in [0, 1)
    assert dplm._uniform(torch.tensor([0, 2 ** 32 - 1])).tolist() == [0.0, 1.0 - 2.0 ** -24]


@pytest.mark.parametrize("S", [20, 64, 300])
def test_diffusion_loss_and_grads_match_jax(rng, monkeypatch, S):
    jcfg, pcfg, jm, params, port = _pair(rng)
    b = _tokens(4, S)
    tokens, valid = torch.from_numpy(b["tokens"]), torch.from_numpy(b["mask"])
    draw = dplm.corrupt(DropoutSeeds(1, 0), tokens, valid)
    assert draw[1].any()
    _patch_jax_corrupt(monkeypatch, [draw, draw])

    def jloss(p):
        return jax_dplm.diffusion_loss_from_apply(jm.apply, p, jax.random.PRNGKey(0),
                                                  jnp.asarray(b["tokens"]), jnp.asarray(b["mask"]))

    (l_j, m_j), g_j = jax.value_and_grad(jloss, has_aux=True)(params)
    loss, metrics = dplm.diffusion_loss_from_draw(port, tokens, valid, *draw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-4)
    for k in ("denoise_accuracy", "mean_t"):
        np.testing.assert_allclose(float(metrics[k]), float(m_j[k]), rtol=1e-6, err_msg=k)
    want = flax_to_state_dict(g_j)
    for k, p in port.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def _jax_state(jcfg, jm, params, batch):
    js = jax_create_train_state(jm, jcfg, jax.tree_util.tree_map(jnp.asarray, batch))
    return js.replace(params=params, opt_state=js.tx.init(params))


def test_three_train_steps_match_jax(rng, monkeypatch):
    """Each step's loss and metrics from the same weights, batches and
    draws: the port's step draws from (state key, step), JAX's `corrupt`
    returns that draw."""
    jcfg, pcfg, jm, params, port = _pair(rng)
    batches = [_tokens(8, 64, seed=s) for s in range(3)]
    pst = create_train_state(port, pcfg, init=False)
    draws = [dplm.corrupt(DropoutSeeds(pst.key, i), torch.from_numpy(b["tokens"]),
                          torch.from_numpy(b["mask"])) for i, b in enumerate(batches)]
    _patch_jax_corrupt(monkeypatch, draws)
    js = _jax_state(jcfg, jm, params, batches[0])
    jstep, pstep = jax_make_train_step(jcfg), make_train_step(pcfg)
    for b in batches:
        js, jm_ = jstep(js, jax.tree_util.tree_map(jnp.asarray, b))
        pst, pm = pstep(pst, to_device(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jm_["loss"]), rtol=1e-4)
        for k in ("denoise_accuracy", "mean_t"):
            np.testing.assert_allclose(float(pm[k]), float(jm_[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert pst.step == 3 and pst.opt_state.count == 3


def test_eval_step_matches_jax_and_leaves_the_state(rng, monkeypatch):
    jcfg, pcfg, jm, params, port = _pair(rng)
    b = _tokens(8, 64, seed=7)
    pst = create_train_state(port, pcfg, init=False)
    pst.step = 5
    draw = dplm.corrupt(DropoutSeeds(pst.key, 5), torch.from_numpy(b["tokens"]),
                        torch.from_numpy(b["mask"]))
    _patch_jax_corrupt(monkeypatch, [draw])
    want = jax_make_eval_step(jcfg)(_jax_state(jcfg, jm, params, b),
                                    jax.tree_util.tree_map(jnp.asarray, b))
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    step = make_eval_step(pcfg)
    got, again = step(pst, to_device(b, "cpu")), step(pst, to_device(b, "cpu"))
    assert pst.step == 5 and pst.opt_state.count == 0
    assert all(torch.equal(p, before[k]) for k, p in port.named_parameters())
    assert all(torch.equal(got[k], again[k]) for k in got)
    for k in ("loss", "denoise_accuracy", "mean_t"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


def test_registry_data_matches_jax():
    from clip_dplm_tpu.experiments.registry import build_data as jax_build_data

    jcfg, pcfg = _cfgs(["train.batch_size=64"])
    jtrain, jval = jax_build_data(jcfg)
    ptrain, pval = build_data(pcfg)
    for fj, fp in ((lambda: jtrain(seed=2), lambda: ptrain(seed=2)), (jval, pval)):
        got, want = list(fp()), list(fj())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["tokens"].shape == (64, 64)


@pytest.mark.parametrize("tie", [True, False])
def test_init_dplm_from_esm_matches_jax(rng, tie):
    """An ESM-2-style tower with more layers than the DPLM: the shared
    layers, embedding and final LayerNorm carry over; the tied head is the
    (vocab, d) embedding itself in the port's (out, in) layout."""
    _, pcfg, jm, dparams, port = _pair(rng)
    ecfg = dict(name="t", vocab_size=33, d_model=64, num_layers=3, num_heads=2)
    jesm = JaxESMTower(cfg=JaxESMConfig(**ecfg), dtype=jnp.float32)
    eparams = rng_params(jesm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"],
                         rng)
    want = flax_to_state_dict(jax_dplm.init_dplm_from_esm(eparams, dparams, tie_lm_head=tie))
    esm = load_flax_params(ESMTower(ESMConfig(**ecfg), dtype=torch.float32), eparams)
    got = dplm.init_dplm_from_esm(esm, port, tie_lm_head=tie).state_dict()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    if tie:
        assert torch.equal(port.lm_head.kernel, port.embed_tokens.embedding)


def test_train_cli_one_epoch_dplm(capsys, tmp_path):
    over = [a for o in SMALL[1:4] + ["train.batch_size=64", "train.optim.warmup_steps=2"]
            for a in ("-o", o)]
    hist = train_cli.main(["--device", "cpu", "--epochs", "1", "-o", "experiment=dplm", *over,
                           "-o", f"logging.log_dir={tmp_path}"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["experiment"] == "dplm" and lines[0]["device"] == "cpu"
    assert lines[1]["epoch"] == 0 and np.isfinite(lines[1]["train_loss"])
    assert np.isfinite(lines[1]["val_loss"])  # 153 validation rows: two batches of 64
    assert lines[-1]["done"] and len(hist["train_loss"]) == 1


def test_bench_dplm_step():
    """The bench's DPLM configuration and FLOP count (640/12/10, B=256,
    S=128: 11.987 TFLOP a step), its batch, and that the rule takes the
    saved mode there."""
    cfg = pconfig.apply_overrides(pconfig.Config(), bench.DPLM_OVERRIDES)
    c = cfg.dplm
    assert (c.d_model, c.num_layers, c.num_heads, c.max_len) == (640, 12, 10, 128)
    assert bench.MODELS["dplm"][1] == 256
    assert bench.dplm_step_flops(cfg, 256) == pytest.approx(11.987111e12, rel=1e-6)
    b = bench.dplm_batch(cfg, 256, np.random.default_rng(0))
    lens = b["mask"].sum(1) - 2
    assert b["tokens"].shape == (256, 128) and lens.min() >= 64 and lens.max() < 126
    # the rule (unpinned): saved at the bench's and the CLI's shapes
    assert SAVES_PROBS(256, 128, 10) and SAVES_PROBS(128, 64, 10)


def test_config_keeps_unported_dplm_fields_out():
    # guidance, guidance_scale and num_candidates are ported (guided sampling)
    assert pconfig.apply_overrides(pconfig.Config(), ["dplm.guidance=none"]).dplm.guidance == "none"
    with pytest.raises(KeyError, match="scan_layers"):
        pconfig.apply_overrides(pconfig.Config(), ["dplm.scan_layers=true"])
    # the LoRA fields are ported (models/lora.py)
    lora_cfg = pconfig.apply_overrides(pconfig.Config(), [
        "dplm.lora_rank=4", "dplm.lora_alpha=8", 'dplm.lora_targets=["q","out"]'])
    assert (lora_cfg.dplm.lora_rank, lora_cfg.dplm.lora_alpha,
            lora_cfg.dplm.lora_targets) == (4, 8.0, ("q", "out"))
