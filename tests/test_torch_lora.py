"""The port's LoRA adapters (clip_dplm_tpu_torch/models/lora.py, the adapted
EsmBlock of models/esm.py, the frozen-base optimizer of train/state.py, the
train CLI's --save-adapters) case for case against tests/test_lora.py, and
against the JAX package on the same numpy weights, at a small size (ESM tower
2 layers, d=64, 4 heads; DPLM 2 layers, d=64, 2 heads), f32:

- the tower with all six targets and nonzero adapters against JAX's at S =
  20 (plain attention), 70 (the packed short-S route: deltas added into the
  packed qkv, `out` merged into the kernel's weight) and 260 (the flash
  route): output rtol 1e-4 / atol 1e-5, every adapter leaf's gradient 1e-4
  of its largest entry, and no gradient computed for a frozen base site;
- three LoRA DPLM train steps and one LoRA esm_clip step against JAX's:
  losses rtol 1e-4, every adapter leaf's first gradient as above;
- adapter files written by either package load in the other.

JAX on the CPU computes its attention exactly (XLA), so the port's packed
attention is pinned to its recompute mode, as tests/test_torch_esm_clip.py
does."""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.models import dplm as jax_dplm
from clip_dplm_tpu.models import esm as jax_esm
from clip_dplm_tpu.models import lora as jax_lora
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train import trainer as jtrainer
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.experiments import train as train_cli
from clip_dplm_tpu_torch.experiments.registry import build_model
from clip_dplm_tpu_torch.models import dplm
from clip_dplm_tpu_torch.models import lora
from clip_dplm_tpu_torch.models.esm import EsmBlock, ESMTower
from clip_dplm_tpu_torch.models.layers import init_params
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.train import trainer as ptrainer
from clip_dplm_tpu_torch.train.state import build_optimizer, create_train_state, freeze_subtrees
from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params
from test_torch_dplm_train import _patch_jax_corrupt
from test_torch_dplm_train import _tokens as dplm_tokens
from test_torch_esm import _tokens, rng_params

ALL = ("q", "k", "v", "out", "ffn_in", "ffn_out")
ALL_JSON = json.dumps(list(ALL))
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def recompute_mode(monkeypatch):
    """The packed attention's backward recomputes the probabilities in f32."""
    monkeypatch.setattr(sa, "saves_probs", lambda *a: False)


def _esm_cfg(cls, **kw):
    return cls(**{**dict(name="tiny", vocab_size=33, d_model=64, num_layers=2, num_heads=4,
                         max_len=512), **kw})


def _tower(**kw):
    model = ESMTower(_esm_cfg(pconfig.ESMConfig, **kw), dtype=torch.float32)
    init_params(model, torch.Generator().manual_seed(0))
    return model


def _nonzero_adapters(model, seed=1):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if lora.is_lora_path(k):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model


def _toks(rng, B=4, S=18):
    return torch.from_numpy(_tokens(rng, B, S, with_mask_tokens=False)[0])


def _assert_grads(port, want, frozen_none=True):
    """Every adapter leaf's gradient against JAX's (1e-4 of its largest
    entry); the frozen base sites have no gradient at all."""
    for k, p in port.named_parameters():
        if lora.is_lora_path(k):
            w = want[k].numpy()
            assert np.abs(w).max() > 0, k
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=k)
        elif frozen_none and k.split(".")[-2] in ALL:
            assert p.grad is None, k
            assert not want[k].abs().max() > 0, k


# ---------------------------------------------------------------------------
# tests/test_lora.py, case for case
# ---------------------------------------------------------------------------


def test_spec_validation():
    with pytest.raises(ValueError):
        lora.LoRASpec(rank=4, targets=("q", "bogus"))
    with pytest.raises(ValueError):
        lora.LoRASpec(rank=0)
    assert lora.spec_from(_esm_cfg(pconfig.ESMConfig)) is None
    spec = lora.spec_from(_esm_cfg(pconfig.ESMConfig, lora_rank=4, lora_alpha=8.0,
                                   lora_targets=("q", "out")))
    want = jax_lora.spec_from(_esm_cfg(jconfig.ESMConfig, lora_rank=4, lora_alpha=8.0,
                                       lora_targets=("q", "out")))
    assert (spec.rank, spec.alpha, spec.targets, spec.scale) == (
        want.rank, want.alpha, want.targets, want.scale) == (4, 8.0, ("q", "out"), 2.0)


@pytest.mark.parametrize("S", [18, 70])
def test_init_matches_base_model(rng, S):
    """b is zero at init, so the adapted model is the base model; the base
    tree is the non-LoRA model's, key for key."""
    toks = _toks(rng, S=S)
    adapted = _tower(lora_rank=4, lora_targets=ALL)
    assert lora.has_lora_params(adapted.state_dict())
    base, adapters = lora.split_lora(adapted.state_dict())
    plain = ESMTower(_esm_cfg(pconfig.ESMConfig), dtype=torch.float32)
    assert set(base) == set(plain.state_dict()) and not lora.has_lora_params(base)
    assert all(not v.b.abs().max() > 0 for k, v in adapted.named_modules() if k.endswith("_lora"))
    plain.load_state_dict(base)
    with torch.no_grad():
        np.testing.assert_allclose(adapted(toks).numpy(), plain(toks).numpy(), atol=1e-6)


@pytest.mark.parametrize("S", [18, 70])
def test_grads_flow_to_adapters_not_base(rng, S):
    toks = _toks(rng, S=S)
    tower = _nonzero_adapters(_tower(lora_rank=4, lora_targets=ALL))
    tower(toks, pooling="mean_residues").square().sum().backward()
    blk = tower.layer_0
    # the frozen base is detached at use: its dW is never formed
    for site in ALL:
        assert getattr(blk, site).kernel.grad is None, site
    for site in ALL:
        pair = getattr(blk, f"{site}_lora")
        assert pair.a.grad.abs().max() > 0 and pair.b.grad.abs().max() > 0, site


def test_optimizer_freezes_base_and_masks_moments(rng):
    """Moments exist only for the adapters and the head; one update moves
    them and leaves every frozen leaf exactly as it was."""
    model = torch.nn.Module()
    model.esm_tower = _nonzero_adapters(_tower(lora_rank=2))
    model.head = torch.nn.Linear(64, 8)
    params = dict(model.named_parameters())
    cfg = pconfig.apply_overrides(pconfig.Config(), ["train.optim.warmup_steps=0"])
    tx = freeze_subtrees(build_optimizer(cfg.train.optim), params, ("esm_tower",))
    assert tx.mask_moments
    state = tx.init(params)
    trainable = [k for k in params if k.startswith("head.") or lora.is_lora_path(k)]
    assert sorted(state.mu) == sorted(trainable) and len(trainable) < len(params)
    before = {k: p.detach().clone() for k, p in params.items()}
    tx.update({k: torch.ones_like(p) for k, p in params.items()}, state, params)
    for k, p in params.items():
        if k in trainable:
            assert not torch.equal(p, before[k]), k
        else:
            assert torch.equal(p, before[k]), k
    # without adapters the moments of a frozen subtree are kept (the chain)
    plain = {"esm_tower.w": torch.zeros(3), "head.w": torch.zeros(2)}
    tx2 = freeze_subtrees(build_optimizer(cfg.train.optim), plain, ("esm_tower",))
    assert not tx2.mask_moments and sorted(tx2.init(plain).mu) == sorted(plain)


def test_merge_matches_adapted_forward(rng):
    """merge_lora folds the adapters into the kernels: the non-LoRA tower on
    the merged weights equals the adapted tower, and equals JAX's merge."""
    toks = _toks(rng, S=70)
    cfg = _esm_cfg(pconfig.ESMConfig, lora_rank=4, lora_alpha=6.0, lora_targets=ALL)
    tower = _nonzero_adapters(_tower(lora_rank=4, lora_alpha=6.0, lora_targets=ALL))
    merged = lora.merge_lora(tower.state_dict(), lora.spec_from(cfg))
    assert not lora.has_lora_params(merged)
    plain = ESMTower(_esm_cfg(pconfig.ESMConfig), dtype=torch.float32)
    plain.load_state_dict(merged)
    with torch.no_grad():
        adapted = tower(toks, pooling="mean_residues")
        np.testing.assert_allclose(plain(toks, pooling="mean_residues").numpy(),
                                   adapted.numpy(), **F32)
        plain.load_state_dict(lora.split_lora(tower.state_dict())[0])
        assert (plain(toks, pooling="mean_residues") - adapted).abs().max() > 1e-4
    want = jax_lora.merge_lora(_flax_tree(tower.state_dict()),
                               jax_lora.spec_from(_esm_cfg(jconfig.ESMConfig, lora_rank=4,
                                                           lora_alpha=6.0, lora_targets=ALL)))
    want = flax_to_state_dict(want)
    assert want.keys() == merged.keys()
    for k in want:
        np.testing.assert_allclose(merged[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    with pytest.raises(ValueError, match="no base site"):
        lora.merge_lora({"x_lora.a": torch.ones(2, 1), "x_lora.b": torch.ones(1, 2)},
                        lora.spec_from(cfg))


def _flax_tree(sd):
    from clip_dplm_tpu_torch.utils.convert import state_dict_to_flax

    return jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(sd))


def test_split_merge_roundtrip():
    sd = _tower(lora_rank=2).state_dict()
    base, adapters = lora.split_lora(sd)
    assert lora.has_lora_params(adapters) and not lora.has_lora_params(base)
    assert all(k.split(".")[1] in ("q_lora", "v_lora") for k in adapters)
    back = lora.merge_adapters(base, adapters)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def _dplm_cfgs(extra=()):
    over = ["experiment=dplm", "dplm.d_model=64", "dplm.num_layers=2", "dplm.num_heads=2",
            "dplm.lora_rank=2", "train.batch_size=8", "train.optim.schedule=constant",
            "train.optim.learning_rate=1e-3", *extra]
    return (jconfig.apply_overrides(jconfig.Config(), over),
            pconfig.apply_overrides(pconfig.Config(), over))


def test_dplm_lora_train_state():
    """DPLM + LoRA: the automatic frozen keys leave the adapters, final_ln
    and lm_head trainable; a step moves only those, and the frozen leaves
    have no moments."""
    _, cfg = _dplm_cfgs()
    model = build_model(cfg, dtype=torch.float32)
    state = create_train_state(model, cfg)
    _nonzero_adapters(model)
    assert state.tx.frozen == ("embed_tokens", "layer_0", "layer_1") and state.tx.mask_moments
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, _ = make_train_step(cfg)(state, to_device(dplm_tokens(8, 20), "cpu"))
    moved = {k for k, p in model.named_parameters() if not torch.equal(p, before[k])}
    assert any(lora.is_lora_path(k) for k in moved) and any(k.startswith("lm_head.")
                                                            for k in moved)
    for k in moved:
        assert lora.is_lora_path(k) or k.split(".")[0] in ("lm_head", "final_ln"), k
    assert sorted(state.opt_state.mu) == sorted(
        k for k in before if lora.is_lora_path(k) or k.split(".")[0] in ("lm_head", "final_ln"))


def test_dplm_lora_with_scan_layers(rng):
    """A JAX LoRA DPLM in the scan_layers layout (adapters stacked under
    layers/block) loads into the port, unstacked, with the same logits."""
    jcfg, pcfg = _dplm_cfgs()
    jcfg = jconfig.apply_overrides(jcfg, ["dplm.scan_layers=true"])
    jm = jax_dplm.DPLM(cfg=jcfg.dplm, dtype=jnp.float32)
    params = rng_params(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8), jnp.int32))["params"], rng)
    assert params["layers"]["block"]["q_lora"]["a"].shape[0] == 2
    b = dplm_tokens(3, 70)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(b["tokens"]),
                             jnp.asarray(b["mask"]))
    port = load_flax_params(build_model(pcfg, dtype=torch.float32), params)
    with torch.no_grad():
        got = port(torch.from_numpy(b["tokens"]), torch.from_numpy(b["mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adapter_npz_crosses_packages(tmp_path, rng, writer):
    """An adapter file written by either package loads in the other, leaf
    for leaf; merged over the base, the JAX tower equals the port's."""
    toks, mask = _tokens(rng, 3, 70, with_mask_tokens=False)
    jt = jax_esm.ESMTower(cfg=_esm_cfg(jconfig.ESMConfig, lora_rank=2, lora_targets=ALL),
                          dtype=jnp.float32)
    params = rng_params(jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(toks[:, :8]))[
        "params"], rng)
    port = load_flax_params(ESMTower(_esm_cfg(pconfig.ESMConfig, lora_rank=2, lora_targets=ALL),
                                     dtype=torch.float32), params)
    path = str(tmp_path / "adapters.npz")
    if writer == "jax":
        assert jax_lora.save_adapters_npz(path, params) == 2 * 6 * 2
        ada = lora.load_adapters_npz(path)
        want = lora.split_lora(port.state_dict())[1]
        assert ada.keys() == want.keys()
        assert all(torch.equal(ada[k], want[k]) for k in ada)
        port.load_state_dict(ada, strict=False)
    else:
        _nonzero_adapters(port)
        assert lora.save_adapters_npz(path, dict(port.named_parameters())) == 2 * 6 * 2
        base, _ = jax_lora.split_lora(params)
        params = jax_lora.merge_adapters(base, jax_lora.load_adapters_npz(path))
    want = jax.jit(lambda p: jt.apply({"params": p}, jnp.asarray(toks), jnp.asarray(mask),
                                      pooling="mean_residues"))(params)
    with torch.no_grad():
        got = port(torch.from_numpy(toks), torch.from_numpy(mask), pooling="mean_residues")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# against JAX: the tower on every route, DPLM and esm_clip train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [20, 70, 260])
def test_lora_tower_matches_jax(rng, S):
    """All six targets, nonzero adapters: S = 70 takes the packed route
    (the q/k/v deltas in the packed slices, `out` merged into the kernel's
    weight), 20 and 260 the separate one (plain attention, flash)."""
    jt = jax_esm.ESMTower(cfg=_esm_cfg(jconfig.ESMConfig, lora_rank=4, lora_alpha=6.0,
                                       lora_targets=ALL), dtype=jnp.float32)
    toks, mask = _tokens(rng, 3, S)
    params = rng_params(jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(toks[:, :8]),
                                         jnp.asarray(mask[:, :8]))["params"], rng)

    def fwd(p):
        return jt.apply({"params": p}, jnp.asarray(toks), jnp.asarray(mask),
                        pooling="mean_residues")

    want = jax.jit(fwd)(params)
    grads = flax_to_state_dict(jax.jit(jax.grad(lambda p: jnp.sum(fwd(p) ** 2)))(params))
    port = load_flax_params(ESMTower(_esm_cfg(pconfig.ESMConfig, lora_rank=4, lora_alpha=6.0,
                                              lora_targets=ALL), dtype=torch.float32), params)
    got = port(torch.from_numpy(toks), torch.from_numpy(mask), pooling="mean_residues")
    got.square().sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    _assert_grads(port, grads)


@pytest.mark.parametrize("out_site", [True, False])
def test_packed_route_skips_a_frozen_projections_dw(rng, monkeypatch, out_site):
    """The packed attention's backward forms dWo only where the projection
    needs a gradient: the merged `out` adapter's weight does, a frozen base
    does not (ctx.needs_input_grad), as XLA drops JAX's stop_gradient dW."""
    calls = []
    real = sa._proj_param_grads
    monkeypatch.setattr(sa, "_proj_param_grads", lambda *a: calls.append(1) or real(*a))
    targets = ALL if out_site else ("q", "k", "v", "ffn_in", "ffn_out")
    blk = EsmBlock(64, 4, lora=lora.LoRASpec(rank=4, targets=targets))
    init_params(blk, torch.Generator().manual_seed(0))
    _nonzero_adapters(blk)
    x = torch.randn(2, 70, 64, requires_grad=True)
    blk(x, torch.ones(2, 70, dtype=torch.bool), torch.arange(70)).sum().backward()
    assert len(calls) == int(out_site)
    assert blk.out.kernel.grad is None and blk.out.bias.grad is None
    assert x.grad.abs().max() > 0 and blk.q_lora.a.grad.abs().max() > 0


def _jax_dplm_state(jcfg, jm, params, batch):
    # the reference's create_train_state, its model.init jitted
    jit_init = types.SimpleNamespace(init=jax.jit(jm.init), apply=jm.apply)
    js = jax_create_train_state(jit_init, jcfg, jax.tree_util.tree_map(jnp.asarray, batch))
    return js.replace(params=params, opt_state=js.tx.init(params))


def test_three_lora_dplm_steps_match_jax(rng, monkeypatch):
    """Each step's loss from the same weights, batches and draws, and the
    first step's gradient of every adapter leaf (and lm_head, final_ln);
    the frozen leaves end bit-identical, with no moments."""
    jcfg, pcfg = _dplm_cfgs([f"dplm.lora_targets={ALL_JSON}", "dplm.max_len=128"])
    jm = jax_dplm.DPLM(cfg=jcfg.dplm, dtype=jnp.float32)
    params = rng_params(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8), jnp.int32))["params"], rng)
    port = load_flax_params(build_model(pcfg, dtype=torch.float32), params)
    batches = [dplm_tokens(8, 64, seed=s) for s in range(3)]
    pst = create_train_state(port, pcfg, init=False)
    draws = [dplm.corrupt(DropoutSeeds(pst.key, i), torch.from_numpy(b["tokens"]),
                          torch.from_numpy(b["mask"])) for i, b in enumerate(batches)]
    _patch_jax_corrupt(monkeypatch, [draws[0]] + draws)
    b0 = batches[0]
    # traced once: the patched `corrupt` hands the trace the first draw
    g = jax.jit(jax.grad(lambda p: jax_dplm.diffusion_loss_from_apply(
        jm.apply, p, jax.random.PRNGKey(0), jnp.asarray(b0["tokens"]),
        jnp.asarray(b0["mask"]))[0]))(params)
    loss, _ = dplm.diffusion_loss_from_draw(port, torch.from_numpy(b0["tokens"]),
                                            torch.from_numpy(b0["mask"]), *draws[0])
    loss.backward()
    _assert_grads(port, flax_to_state_dict(g))
    for k in ("lm_head.kernel", "final_ln.scale"):
        w = flax_to_state_dict(g)[k].numpy()
        np.testing.assert_allclose(port.get_parameter(k).grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    frozen = {k: p.detach().clone() for k, p in port.named_parameters()
              if pst.tx.is_frozen(k)}
    js = _jax_dplm_state(jcfg, jm, params, b0)
    jstep, pstep = jax_make_train_step(jcfg), make_train_step(pcfg)
    for b in batches:
        js, jmetrics = jstep(js, jax.tree_util.tree_map(jnp.asarray, b))
        pst, pm = pstep(pst, to_device(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    assert all(torch.equal(port.get_parameter(k), v) for k, v in frozen.items())
    assert frozen and not set(frozen) & set(pst.opt_state.mu)
    want = flax_to_state_dict(js.params)
    for k, p in port.named_parameters():
        if lora.is_lora_path(k):
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


@functools.lru_cache(maxsize=None)
def _esm_clip_pair():
    """(JAX config, port config, JAX model, params, port model) of a LoRA
    esm_clip (the ESM tower frozen, all six targets) on the same weights."""
    from test_torch_esm_clip import STEP, _batch, _cfgs, _jnp

    from clip_dplm_tpu.models.protein_clip import ESMProteinCLIP as JaxESMProteinCLIP
    from clip_dplm_tpu_torch.models.protein_clip import ESMProteinCLIP

    jcfg, pcfg = _cfgs(list(STEP) + ["esm.frozen=true", "esm.lora_rank=4",
                                     f"esm.lora_targets={ALL_JSON}"])
    jm = JaxESMProteinCLIP(cfg=jcfg, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), _jnp(_batch()))["params"]
    params = dict(rng_params(params, np.random.default_rng(3)), logit_scale=jnp.float32(2.6592))
    port = load_flax_params(ESMProteinCLIP(pcfg, dtype=torch.float32), params)
    return jcfg, pcfg, jm, params, port


def test_lora_esm_clip_step_matches_jax():
    """One LoRA esm_clip step: the loss, every adapter leaf's gradient (the
    frozen tower runs with a gradient, which reaches only the adapters), the
    step's loss and update of the adapters against JAX's."""
    from test_torch_esm_clip import _batch, _jnp

    jcfg, pcfg, jm, params, port = _esm_clip_pair()
    batch = _batch(seed=0)
    jloss = jtrainer._pair_loss_fn(jcfg)
    g = jax.jit(jax.grad(lambda p, b: jloss(p, jm.apply, b, jax.random.PRNGKey(0), None,
                                            None)[0]))(params, _jnp(batch))
    loss, _ = ptrainer._pair_loss_fn(pcfg)(port, to_device(batch, "cpu"), DropoutSeeds(0, 0))
    loss.backward()
    want = flax_to_state_dict(g)
    _assert_grads(port, {k[len("esm_tower."):]: v for k, v in want.items()
                         if k.startswith("esm_tower.")} | want, frozen_none=False)
    for k, p in port.named_parameters():
        if k.startswith("esm_tower.") and k.split(".")[-2] in ALL:
            assert p.grad is None, k
    jit_init = types.SimpleNamespace(init=jax.jit(jm.init, static_argnames="deterministic"),
                                     apply=jm.apply)
    js = jax_create_train_state(jit_init, jcfg, _jnp(batch))
    js = js.replace(params=params, opt_state=js.tx.init(params))
    js, jmetrics = jax.jit(jax_make_train_step(jcfg))(js, _jnp(batch))
    port.zero_grad(set_to_none=True)
    pst = create_train_state(port, pcfg, init=False)
    assert pst.tx.mask_moments and all(
        lora.is_lora_path(k) for k in pst.opt_state.mu if k.startswith("esm_tower."))
    frozen = {k: p.detach().clone() for k, p in port.named_parameters() if pst.tx.is_frozen(k)}
    pst, pm = make_train_step(pcfg)(pst, to_device(batch, "cpu"))
    np.testing.assert_allclose(float(pm["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    assert all(torch.equal(port.get_parameter(k), v) for k, v in frozen.items())
    want = flax_to_state_dict(js.params)
    for k, p in port.named_parameters():
        if lora.is_lora_path(k):
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


def test_train_cli_saves_adapters(tmp_path, capsys):
    """-o dplm.lora_rank with --save-adapters: the .npz holds only the
    `*_lora` leaves, under the flax paths JAX's loader reads; a model
    without adapters is refused before training."""
    path = str(tmp_path / "adapters.npz")
    over = ["experiment=dplm", "dplm.d_model=64", "dplm.num_layers=2", "dplm.num_heads=2",
            "dplm.lora_rank=2", "train.batch_size=64", "train.optim.warmup_steps=2"]
    train_cli.main(["--device", "cpu", "--epochs", "1", "--save-adapters", path,
                    *[a for o in over for a in ("-o", o)], "-o", f"logging.log_dir={tmp_path}"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert {"adapters": path, "leaves": 2 * 2 * 2} in lines
    with np.load(path) as z:
        assert sorted(z.files) == sorted(f"layer_{i}/{s}_lora/{p}" for i in range(2)
                                         for s in ("q", "v") for p in "ab")
    ada = jax_lora.load_adapters_npz(path)
    assert ada["layer_0"]["q_lora"]["a"].shape == (64, 2)
    with pytest.raises(SystemExit, match="no LoRA adapters"):
        train_cli.main(["--device", "cpu", "--epochs", "1", "--save-adapters", path,
                        *[a for o in over[:-3] for a in ("-o", o)],
                        "-o", f"logging.log_dir={tmp_path}"])
