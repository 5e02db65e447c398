"""The rest of the port's train loop (clip_dplm_tpu_torch: config.py's
`precision.remat`, `train.steps_per_call` and `train.optim.fused_update`,
models/layers.py::remat_call on the token towers' and ESM-2's blocks,
train/trainer.py's prefetched, grouped epoch loop, train/state.py::
AdamWChain, the multiway losses' `pairs` and `weights`) against the JAX
package on the same numpy weights and batches, at a small size (the flagship
and esm_clip of tests/test_torch_token_towers.py and test_torch_esm_clip.py,
the two-tower model of test_torch_two_tower.py).

Tolerances: remat on against remat off in the port, loss and every gradient
equal bit for bit (dropout on and off); the port with remat against JAX with
`precision.remat=true`, dropout off, f32: loss rtol 1e-4, every leaf's
gradient within 1e-4 of its largest entry (the token-tower tests' bound).
The Trainer with `steps_per_call=2` against JAX's over 5 batches (the tail
dropped): the epoch losses rtol 1e-4, the parameters within 1e-4 of each
leaf's largest entry plus 2·lr (Adam moves a leaf whose gradient is rounding
noise by about lr a step, on either side), the step count equal. The optax
chain's update against optax on the same gradients: parameters and moments
rtol 1e-5 (bf16 mu: one bf16 unit). The multiway losses: loss rtol 1e-5,
gradients atol 1e-5 / rtol 1e-4. The port's own schedules (steps_per_call
against single steps, a checkpoint round trip) equal bit for bit. JAX on the
CPU computes its attention exactly, so the port's packed attention is pinned
to its recompute mode, as the token-tower tests pin it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.models.protein_clip import ESMProteinCLIP as JaxESMProteinCLIP
from clip_dplm_tpu.models.token_towers import RNARBPCLIP as JaxRNARBPCLIP
from clip_dplm_tpu.ops import fused_infonce as jfi
from clip_dplm_tpu.ops import infonce as jinfonce
from clip_dplm_tpu.train import Trainer as JaxTrainer
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train import state as jstate
from clip_dplm_tpu.train import trainer as jtrainer
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.models.protein_clip import ESMProteinCLIP
from clip_dplm_tpu_torch.models.token_towers import RNARBPCLIP
from clip_dplm_tpu_torch.ops import fused_infonce as fi
from clip_dplm_tpu_torch.ops import infonce
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.train import trainer as ptrainer
from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager
from clip_dplm_tpu_torch.train.state import AdamWChain, build_optimizer, create_train_state
from clip_dplm_tpu_torch.train.trainer import Trainer, make_train_step, to_device
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params
from clip_dplm_tpu_torch.utils.convert import load_flax_train_state
from test_torch_esm import rng_params

import test_torch_esm_clip as esm_clip_t
import test_torch_token_towers as towers_t
import test_torch_two_tower as two_tower_t


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for these small CPU steps (the suite runs six xdist
    workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recompute_mode(monkeypatch):
    """The packed attention's backward recomputes the probabilities in f32."""
    monkeypatch.setattr(sa, "saves_probs", lambda *a: False)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# precision.remat
# ---------------------------------------------------------------------------

# (test module, JAX model class, port model class) of each family
FAMILIES = {"flagship": (towers_t, JaxRNARBPCLIP, RNARBPCLIP),
            "esm_clip": (esm_clip_t, JaxESMProteinCLIP, ESMProteinCLIP)}


@functools.lru_cache(maxsize=None)
def _family(name: str, dropout: bool):
    """(JAX config, port config with remat, JAX model, params, port model
    with remat, port model without) on the same random weights. The JAX
    model runs without remat: its token towers raise under it (see
    test_jax_token_tower_remat_raises), and remat changes no value."""
    mod, jcls, pcls = FAMILIES[name]
    extra = list(mod.STEP if not dropout else mod.STEP[len(mod.NO_DROPOUT):])
    jcfg = jconfig.apply_overrides(jconfig.Config(), mod.SMALL + extra)
    pcfg = pconfig.apply_overrides(pconfig.Config(), mod.SMALL + extra + ["precision.remat=true"])
    jm = jcls(cfg=jcfg, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), _jnp(mod._batch()))["params"]
    params = dict(rng_params(params, np.random.default_rng(3)), logit_scale=jnp.float32(2.6592))
    plain = pconfig.apply_overrides(pcfg, ["precision.remat=false"])
    on = load_flax_params(pcls(pcfg, dtype=torch.float32), params)
    off = load_flax_params(pcls(plain, dtype=torch.float32), params)
    return jcfg, pcfg, jm, params, on, off


def _port_loss_and_grads(cfg, model, batch, seeds):
    for p in model.parameters():
        p.grad = None
    loss, _ = ptrainer._pair_loss_fn(cfg)(model, to_device(batch, "cpu"), seeds)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("name,dropout", [("flagship", True), ("flagship", False),
                                          ("esm_clip", True)])
def test_remat_equals_no_remat_bit_for_bit(name, dropout):
    """The recompute draws the same dropout masks (the seeds are host ints
    in call order, copied at the block's start) and computes the same
    values: loss and every gradient equal to the last bit, and the seeds'
    count after the forward is the same."""
    mod = FAMILIES[name][0]
    _, pcfg, _, _, on, off = _family(name, dropout)
    assert on.rna_tower.remat and not off.rna_tower.remat
    batch = mod._batch()
    seeds_on, seeds_off = DropoutSeeds(7, 3), DropoutSeeds(7, 3)
    l_on, g_on = _port_loss_and_grads(pcfg, on, batch, seeds_on)
    l_off, g_off = _port_loss_and_grads(pcfg, off, batch, seeds_off)
    assert seeds_on.count == seeds_off.count > (4 if dropout else -1)
    assert torch.equal(l_on, l_off)
    assert g_on.keys() == g_off.keys() and len(g_on) > 10
    for k in g_on:
        assert torch.equal(g_on[k], g_off[k]), k


@pytest.mark.parametrize("name", ["flagship", "esm_clip"])
def test_remat_matches_jax(name):
    """The port with remat against JAX's model, dropout off, f32 (JAX's
    `nn.remat` recomputes the same function; its ESM-2 tower under remat is
    held in test_esm_tower_remat_matches_jax_remat)."""
    mod = FAMILIES[name][0]
    jcfg, pcfg, jm, params, on, _ = _family(name, False)
    batch = mod._batch()
    jloss = jtrainer._pair_loss_fn(jcfg)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p, b: jloss(
        p, jm.apply, b, jax.random.PRNGKey(0), None, None)[0]))(params, _jnp(batch))
    want = flax_to_state_dict(want)
    loss, grads = _port_loss_and_grads(pcfg, on, batch, DropoutSeeds(0, 0))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def test_jax_token_tower_remat_raises():
    """A fault of the reference, kept here so that its reason stays on
    record: `nn.remat(TransformerBlock, static_argnums=(3,))` counts the
    module as an argument while `deterministic` is passed by keyword, so
    JAX's token towers cannot run under `precision.remat=true` (the
    flagship, and esm_clip's RNA tower). The port's remat runs there."""
    jcfg = jconfig.apply_overrides(jconfig.Config(), towers_t.SMALL + ["precision.remat=true"])
    with pytest.raises(ValueError, match="static_argnums"):
        JaxRNARBPCLIP(cfg=jcfg, dtype=jnp.float32).init(jax.random.PRNGKey(0),
                                                        _jnp(towers_t._batch()))


def test_esm_tower_remat_matches_jax_remat():
    """The ESM-2 tower under remat on both sides (JAX's nn.remat on each
    EsmBlock runs): pooled output and every gradient, f32."""
    from clip_dplm_tpu.models.esm import ESMTower as JaxESMTower
    from clip_dplm_tpu_torch.models.esm import ESMTower

    from test_torch_esm import _tokens

    jcfg = jconfig.ESMConfig(name="t", d_model=64, num_layers=2, num_heads=4)
    pcfg = pconfig.ESMConfig(name="t", d_model=64, num_layers=2, num_heads=4)
    toks, mask = _tokens(np.random.default_rng(2), 4, 64, with_mask_tokens=False)
    jt = JaxESMTower(cfg=jcfg, dtype=jnp.float32, remat=True)
    params = rng_params(jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(toks))["params"],
                        np.random.default_rng(5))
    w = np.random.default_rng(6).normal(size=(4, 64)).astype(np.float32)

    def jloss(p):
        out = jt.apply({"params": p}, jnp.asarray(toks), jnp.asarray(mask),
                       pooling="mean_residues")
        return jnp.sum(out * w)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    want = flax_to_state_dict(want)
    port = load_flax_params(ESMTower(pcfg, dtype=torch.float32, remat=True), params)
    loss = torch.sum(port(torch.from_numpy(toks), torch.from_numpy(mask),
                          pooling="mean_residues") * torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    for k, p in port.named_parameters():
        g = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max(),
                                   err_msg=k)


def test_remat_reaches_every_block(monkeypatch):
    """Each block of both towers runs under remat_call, the truncated CLS
    block too; without a gradient nothing is checkpointed."""
    from clip_dplm_tpu_torch.models import token_towers

    _, pcfg, _, _, on, _ = _family("flagship", False)
    calls = []
    real = token_towers.remat_call
    monkeypatch.setattr(token_towers, "remat_call",
                        lambda fn, *a: calls.append(fn) or real(fn, *a))
    batch = to_device(towers_t._batch(), "cpu")
    on(batch)
    assert calls == [on.rna_tower.block_0, on.rna_tower.block_1,
                     on.rbp_tower.block_0, on.rbp_tower.block_1]
    assert on.rna_tower.block_1.out_rows == 1
    calls.clear()
    with torch.no_grad():
        on(batch)
    assert calls == []


# ---------------------------------------------------------------------------
# train.steps_per_call and the prefetched epoch loop
# ---------------------------------------------------------------------------

SPC = two_tower_t.STEP + ["train.steps_per_call=2"]


@functools.lru_cache(maxsize=None)
def _jax_spc_run():
    """JAX's Trainer with steps_per_call=2 over 5 batches, one epoch."""
    jcfg, _, jm, params, _ = two_tower_t._pair(SPC, jnp.float32, torch.float32)
    batches = [two_tower_t._batch(seed=s) for s in range(5)]
    js = jax_create_train_state(jm, jcfg, _jnp(batches[0]))
    js = js.replace(params=params, opt_state=js.tx.init(params))
    jt = JaxTrainer(jcfg, js)
    hist = jt.train(lambda: iter(batches), num_epochs=1)
    return hist, flax_to_state_dict(jax.device_get(jt.state.params)), jt._global_step


def _port_spc_run(extra, n=5, epochs=1):
    _, pcfg, _, _, port = two_tower_t._pair(extra, jnp.float32, torch.float32)
    batches = [two_tower_t._batch(seed=s) for s in range(n)]
    trainer = Trainer(pcfg, create_train_state(port, pcfg, init=False))
    hist = trainer.train(lambda: iter(batches), num_epochs=epochs)
    return trainer, hist


def test_steps_per_call_matches_jax():
    jhist, jparams, jsteps = _jax_spc_run()
    trainer, hist = _port_spc_run(SPC)
    assert trainer._global_step == jsteps == 4 and trainer.state.step == 4
    np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"], rtol=1e-4)
    for k, p in trainer.state.model.named_parameters():
        w = jparams[k].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 2e-3, err_msg=k)


def test_steps_per_call_equals_single_steps():
    """Two steps a call over 4 batches give the bytes of 4 single steps;
    a fifth batch is dropped with steps_per_call=2; the epoch's loss is the
    mean of each call's last-step loss."""
    grouped, ghist = _port_spc_run(SPC, n=5)
    single, shist = _port_spc_run(two_tower_t.STEP, n=4)
    assert grouped.state.step == single.state.step == 4
    for (k, a), (_, b) in zip(grouped.state.model.named_parameters(),
                              single.state.model.named_parameters()):
        assert torch.equal(a, b), k
    losses = []
    _, pcfg, _, _, port = two_tower_t._pair(two_tower_t.STEP, jnp.float32, torch.float32)
    state = create_train_state(port, pcfg, init=False)
    step = make_train_step(pcfg)
    for s in range(4):
        state, m = step(state, to_device(two_tower_t._batch(seed=s), "cpu"))
        losses.append(float(m["loss"]))
    assert ghist["train_loss"] == [pytest.approx(np.mean([losses[1], losses[3]]), rel=1e-6)]


def test_stack_batches_and_grouping():
    batches = [{"x": np.full((2, 3), i, np.float32), "n": 4} for i in range(5)]
    stacked = ptrainer.stack_batches(batches[:2])
    assert stacked["x"].shape == (2, 2, 3) and stacked["n"] == 4
    with pytest.raises(ValueError, match="ints differ"):
        ptrainer.stack_batches([{"n": 1}, {"n": 2}])
    _, pcfg, _, _, port = two_tower_t._pair(SPC, jnp.float32, torch.float32)
    trainer = Trainer(pcfg, create_train_state(port, pcfg, init=False))
    groups = list(trainer._grouped(iter(batches)))
    assert len(groups) == 2 and [float(g["x"][1, 0, 0]) for g in groups] == [1.0, 3.0]


def test_trainer_prefetches_and_closes_on_error(monkeypatch):
    """Every train batch comes through the prefetcher as CPU tensors (the
    serial copy is not called); a step that raises closes the worker."""
    from clip_dplm_tpu_torch.data import prefetch

    made = []
    real = prefetch.DevicePrefetcher

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(ptrainer, "DevicePrefetcher", Spy)
    monkeypatch.setattr(ptrainer, "to_device", lambda *a: pytest.fail("serial copy"))
    _, pcfg, _, _, port = two_tower_t._pair(two_tower_t.STEP, jnp.float32, torch.float32)
    trainer = Trainer(pcfg, create_train_state(port, pcfg, init=False))
    seen = []
    inner = trainer.train_step

    def step(state, batch):
        seen.append(batch)
        if len(seen) == 3:
            raise RuntimeError("step failed")
        return inner(state, batch)

    trainer.train_step = step
    with pytest.raises(RuntimeError, match="step failed"):
        trainer.train(lambda: (two_tower_t._batch(seed=s) for s in range(100)), num_epochs=1)
    assert all(isinstance(v, torch.Tensor) for b in seen for v in b.values())
    assert len(made) == 1
    made[0]._thread.join(timeout=2.0)
    assert not made[0]._thread.is_alive()


# ---------------------------------------------------------------------------
# train.optim.fused_update=false: the optax chain
# ---------------------------------------------------------------------------


def _tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("moment_dtype,clip", [("float32", 0.5), ("bfloat16", 0.5),
                                               ("float32", 100.0)])
def test_chain_update_matches_optax(moment_dtype, clip):
    """Three updates of AdamWChain against optax.chain(clip_by_global_norm,
    adamw(mu_dtype)) from JAX's build_optimizer(fused_update=false), on the
    same gradients; clip 0.5 binds, 100 does not."""
    over = ["train.optim.fused_update=false", "train.optim.warmup_steps=2",
            f"train.optim.moment_dtype={moment_dtype}", f"train.optim.grad_clip_norm={clip}",
            "train.optim.learning_rate=1e-2", "train.optim.weight_decay=0.1"]
    jopt = jconfig.apply_overrides(jconfig.Config(), over).train.optim
    popt = pconfig.apply_overrides(pconfig.Config(), over).train.optim
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "s": ()}
    params = _tree(rng, shapes)
    jtx = jstate.build_optimizer(jopt)
    jp, js = _jnp(params), jtx.init(_jnp(params))
    ptx = build_optimizer(popt)
    assert isinstance(ptx, AdamWChain)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = ptx.init(pp)
    for _ in range(3):
        g = _tree(rng, shapes)
        u, js = jtx.update(_jnp(g), js, jp)
        jp = optax.apply_updates(jp, u)
        ptx.update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
    adam = js[-1][0]
    assert ps.count == int(adam.count) == 3
    for k in shapes:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        assert ps.mu[k].dtype == getattr(torch, moment_dtype) and ps.nu[k].dtype == torch.float32
        np.testing.assert_allclose(ps.mu[k].float().numpy(),
                                   np.asarray(adam.mu[k], np.float32),
                                   rtol=1e-5 if moment_dtype == "float32" else 8e-3, atol=1e-8,
                                   err_msg=k)
        np.testing.assert_allclose(ps.nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)


CHAIN = two_tower_t.STEP + ["train.optim.fused_update=false", "train.optim.grad_clip_norm=0.5"]


@functools.lru_cache(maxsize=None)
def _chain_pair():
    jcfg, pcfg, jm, params, port = two_tower_t._pair(CHAIN, jnp.float32, torch.float32)
    batches = [two_tower_t._batch(seed=s) for s in range(3)]
    js = jax_create_train_state(jm, jcfg, _jnp(batches[0]))
    js = js.replace(params=params, opt_state=js.tx.init(params))
    return jcfg, pcfg, js, port, batches


def test_chain_three_steps_match_jax():
    jcfg, pcfg, js, port, batches = _chain_pair()
    jstep = jax.jit(jax_make_train_step(jcfg))
    pst = create_train_state(port, pcfg, init=False)
    assert isinstance(pst.tx, AdamWChain) and not hasattr(pst.opt_state, "prev_norm")
    pstep = make_train_step(pcfg)
    for b in batches:
        js, jm = jstep(js, _jnp(b))
        pst, pm = pstep(pst, to_device(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-4)
    assert pst.step == 3 and pst.opt_state.count == 3


def test_chain_state_carries_across_and_round_trips(tmp_path):
    """JAX's chain state (random moments, count 5) into the port's, then a
    checkpoint round trip, exact; a fused JAX state does not load into the
    chain."""
    jcfg, pcfg, js, port, _ = _chain_pair()
    rng = np.random.default_rng(1)
    fill = lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32))  # noqa: E731
    clip_state, (adam, *rest) = js.opt_state
    adam = adam._replace(count=jnp.int32(5), mu=jax.tree_util.tree_map(fill, adam.mu),
                         nu=jax.tree_util.tree_map(lambda x: abs(fill(x)), adam.nu))
    jax_state = {"step": jnp.int32(5), "params": js.params,
                 "opt_state": (clip_state, (adam, *rest))}
    pst = create_train_state(port, pcfg, init=False)
    load_flax_train_state(pst, jax_state)
    assert (pst.step, pst.opt_state.count) == (5, 5)
    want_mu = flax_to_state_dict(jax.device_get(adam.mu))
    for k, v in pst.opt_state.mu.items():
        np.testing.assert_array_equal(v.numpy(), want_mu[k].numpy())
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(pst, 5)
    fresh = create_train_state(two_tower_t._pair(CHAIN, jnp.float32, torch.float32)[4], pcfg,
                               init=False)
    mgr.restore(fresh)
    assert (fresh.step, fresh.opt_state.count) == (5, 5)
    for attr in ("mu", "nu"):
        for k, v in getattr(pst.opt_state, attr).items():
            assert torch.equal(getattr(fresh.opt_state, attr)[k], v), (attr, k)
    fused_tx = jstate.build_optimizer(
        jconfig.apply_overrides(jcfg, ["train.optim.fused_update=true"]).train.optim)
    with pytest.raises(ValueError, match="fused_update must agree"):
        load_flax_train_state(pst, {"step": 0, "params": js.params,
                                    "opt_state": fused_tx.init(js.params)})


# ---------------------------------------------------------------------------
# the multiway losses' pairs and weights
# ---------------------------------------------------------------------------

NAMES = ("cell", "pert", "protein")
PAIRS = (("cell", "pert"), ("pert", "protein"), ("cell", "missing"), ("protein", "cell"))
WEIGHTS = {("cell", "pert"): 0.25, ("protein", "cell"): 2.0, ("cell", "missing"): 9.0}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("pairs", [None, PAIRS])
def test_multiway_pairs_and_weights_match_jax(fused, pairs):
    """Unequal weights, a pair naming a missing modality (skipped), a
    reversed pair; loss, metrics and the gradients of every embedding and
    the logit scale."""
    rng = np.random.default_rng(7)
    args = [rng.normal(size=(40, 24)).astype(np.float32) for _ in NAMES] + [np.float32(2.3)]
    pfn = fi.fused_multiway_clip_loss if fused else infonce.multiway_clip_loss
    jfn = jfi.fused_multiway_clip_loss if fused else jinfonce.multiway_clip_loss
    targs = [torch.tensor(v, requires_grad=True) for v in args]
    loss, metrics = pfn(dict(zip(NAMES, targs[:3])), targs[3], pairs=pairs, weights=WEIGHTS)
    loss.backward()
    with pltpu.force_tpu_interpret_mode():
        (want, wm), grads = jax.value_and_grad(
            lambda *xs: jfn(dict(zip(NAMES, xs[:3])), xs[3], pairs=pairs, weights=WEIGHTS),
            argnums=(0, 1, 2, 3), has_aux=True)(*map(jnp.asarray, args))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert sorted(metrics) == sorted(wm)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(wm[k]), rtol=1e-5,
                                   err_msg=k)
    for t, g, name in zip(targs, grads, NAMES + ("logit_scale",)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
