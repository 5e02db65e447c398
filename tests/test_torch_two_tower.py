"""The port's two-tower train path (clip_dplm_tpu_torch: models/clip.py,
models/layers.py, train/state.py, train/trainer.py, experiments/) against the
JAX package on the same numpy weights and batches, at a small width (towers
24/40 -> 128, projection 128, hidden 256): the forward of TwoTowerCLIP in f32
and bf16, fused and unfused; three train steps and a grad-accumulation step
at f32 compute with dropout 0 (loss rtol 1e-4, parameters atol 1e-5; on
the fully fused path the loss and the first step's gradients); the
fused AdamW and the schedules against their JAX counterparts; weight
conversion with strict loading; and the train CLI for one epoch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.models import TwoTowerCLIP as JaxTwoTowerCLIP
from clip_dplm_tpu.ops import fused_dense as jfd
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train import state as jstate
from clip_dplm_tpu.train import trainer as jtrainer
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.experiments import train as train_cli
from clip_dplm_tpu_torch.experiments.registry import build_model
from clip_dplm_tpu_torch.models.clip import TwoTowerCLIP
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.train import state as pstate
from clip_dplm_tpu_torch.train import trainer as ptrainer
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params
from test_torch_esm import rng_params

SMALL = ["tower_a.input_dim=24", "tower_a.hidden_size=128", "tower_a.num_hidden_layers=2",
         "tower_b.input_dim=40", "tower_b.hidden_size=128", "tower_b.num_hidden_layers=2",
         "projection.dim=128", "projection.hidden_dim=256", "train.batch_size=32"]
FUSED = ["tower_a.fused_dense=true", "tower_b.fused_dense=true",
         "projection.fused_dense=true", "contrastive.use_fused_kernel=true"]
STEP = ["projection.dropout=0.0", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"]


def _cfgs(extra):
    return (jconfig.apply_overrides(jconfig.Config(), SMALL + extra),
            pconfig.apply_overrides(pconfig.Config(), SMALL + extra))


def _batch(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 24)).astype(np.float32),
            "b": rng.normal(size=(n, 40)).astype(np.float32)}


def _pair(extra, dtype_j, dtype_p, seed=0, jax_init=False):
    jcfg, pcfg = _cfgs(extra)
    jm = JaxTwoTowerCLIP(cfg=jcfg, dtype=dtype_j)
    params = jm.init(jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, _batch()),
                     deterministic=True)["params"]
    if not jax_init:
        params = rng_params(params, np.random.default_rng(seed))
        params = dict(params, logit_scale=jnp.float32(2.6592))
    port = load_flax_params(TwoTowerCLIP(pcfg, dtype=dtype_p), params)
    return jcfg, pcfg, jm, params, port


@pytest.fixture
def fused_jax(monkeypatch):
    """The JAX package's fused routes on the CPU: Pallas in interpret mode."""
    monkeypatch.setattr(jfd, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jtrainer, "_fused_ok", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("kind,fused", [("optimized", False), ("optimized", True),
                                        ("base", False), ("base", True), ("linear", False)])
def test_forward_matches_flax_f32(request, kind, fused):
    if fused:
        request.getfixturevalue("fused_jax")
    extra = [f"projection.kind={kind}"] + (FUSED if fused else [])
    _, _, jm, params, port = _pair(extra, jnp.float32, torch.float32)
    batch = _batch()
    want = jm.apply({"params": params}, jax.tree_util.tree_map(jnp.asarray, batch),
                    deterministic=True)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("emb_a", "emb_b"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(float(got["logit_scale"].detach()), float(want["logit_scale"]))


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_flax_bf16(request, fused):
    if fused:
        request.getfixturevalue("fused_jax")
    _, _, jm, params, port = _pair(FUSED if fused else [], jnp.bfloat16, torch.bfloat16)
    batch = _batch()
    want = jm.apply({"params": params}, jax.tree_util.tree_map(jnp.asarray, batch),
                    deterministic=True)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("emb_a", "emb_b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k], np.float32),
                                   rtol=0.05, atol=0.03)


def _run_steps(extra, n_steps, batch_n=32, check_params=True):
    jcfg, pcfg, jm, params, port = _pair(STEP + extra, jnp.float32, torch.float32)
    batches = [_batch(batch_n, seed=s) for s in range(n_steps)]
    jstate0 = jax_create_train_state(jm, jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                                     batches[0]))
    jstate0 = jstate0.replace(params=params, opt_state=jstate0.tx.init(params))
    jstep = jax.jit(jax_make_train_step(jcfg))
    pst = create_train_state(port, pcfg, init=False)
    pstep = make_train_step(pcfg)
    js = jstate0
    for b in batches:
        js, jm_metrics = jstep(js, jax.tree_util.tree_map(jnp.asarray, b))
        pst, pm = pstep(pst, to_device(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jm_metrics["loss"]), rtol=1e-4)
    if not check_params:
        return pst
    want = flax_to_state_dict(js.params)
    for k, v in pst.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
    return pst


@pytest.mark.parametrize("fused", [False, True])
def test_three_train_steps_match_jax(request, fused):
    """Unfused, and with every Dense+LN block fused (the plain loss)."""
    if fused:
        request.getfixturevalue("fused_jax")
    pst = _run_steps(FUSED[:3] if fused else [], 3)
    assert pst.step == 3 and pst.opt_state.count == 3


def test_three_train_steps_with_fused_loss_match_jax(fused_jax):
    """The whole fused path. Both trainers feed the fused loss bf16
    similarity operands, and embeddings that agree to f32 rounding can round
    to different bf16 values; Adam's first steps turn the sign of a near-zero
    gradient into a +-lr update, so the parameters are not held to 1e-5 here:
    the loss of every step is, and the gradients before Adam are in
    test_first_step_gradients_with_fused_loss_match_jax."""
    _run_steps(FUSED, 3, check_params=False)


def test_first_step_gradients_with_fused_loss_match_jax(fused_jax):
    """The gradient of every leaf on the whole fused path, before the
    optimizer, against jax.grad of the JAX trainer's loss. Bound: one bf16
    rounding step (2^-8) of the leaf's largest entry, the error of one bf16
    operand of the similarity (the port is at most 8e-4 of it at this size,
    JAX's fused loss against its f32 loss up to 7e-3)."""
    jcfg, pcfg, jm, params, port = _pair(STEP + FUSED, jnp.float32, torch.float32)
    batch = _batch()
    jloss = jtrainer._pair_loss_fn(jcfg)
    want = flax_to_state_dict(jax.grad(lambda p: jloss(
        p, jm.apply, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0),
        None, None)[0])(params))
    loss, _ = ptrainer._pair_loss_fn(pcfg)(port, to_device(batch, "cpu"), DropoutSeeds(0, 0))
    loss.backward()
    for k, p in port.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=2.0 ** -8 * np.abs(w).max(),
                                   err_msg=k)


def test_grad_accumulation_matches_jax():
    _run_steps(["train.optim.grad_accum_steps=2", "train.log_grad_norm=true"], 1, 64)


@pytest.mark.parametrize("clip_mode", ["exact", "stale"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_fused_adamw_matches_jax(clip_mode, moments):
    ocfg = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10, grad_clip_norm=0.5,
                weight_decay=0.01, clip_mode=clip_mode, moment_dtype=moments)
    jtx = jstate.build_optimizer(jconfig.OptimConfig(**ocfg))
    ptx = pstate.build_optimizer(pconfig.OptimConfig(**ocfg))
    rng = np.random.default_rng(0)
    init = {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    js, ps = jtx.init(jp), ptx.init(pp)
    for i in range(6):
        g = {k: np.sin(v * (i + 1.0)) * (3.0 if i % 2 else 0.1) for k, v in init.items()}
        u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        ptx.update({k: torch.from_numpy(v.astype(np.float32)) for k, v in g.items()}, ps, pp)
    for k in init:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(ps.mu[k].float().numpy(), np.asarray(js.mu[k], np.float32),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("schedule", ["warmup_cosine", "cosine", "constant"])
def test_schedule_matches_optax(schedule):
    kw = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100, schedule=schedule,
              min_lr_ratio=0.1)
    want = jstate.build_schedule(jconfig.OptimConfig(**kw))
    got = pstate.build_schedule(pconfig.OptimConfig(**kw))
    for count in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)


def test_freeze_subtrees_zeroes_update_and_decay():
    _, pcfg = _cfgs(STEP)
    model = build_model(pcfg, dtype=torch.float32)
    st = create_train_state(model, pcfg, frozen_keys=("tower_a",))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    make_train_step(pcfg)(st, to_device(_batch(), "cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) == k.startswith("tower_a."), k


def test_convert_loads_jax_two_tower_init_strict():
    """A real JAX TwoTowerCLIP init (scalar logit_scale, (1,) layer_scale,
    LayerNorm_0, dense_i, skip/fc0/ln0/.../fc_out/ln_out) loads strictly."""
    jcfg, pcfg = _cfgs(["tower_a.architecture=resnet"])
    params = JaxTwoTowerCLIP(cfg=jcfg).init(
        jax.random.PRNGKey(1), jax.tree_util.tree_map(jnp.asarray, _batch()))["params"]
    port = TwoTowerCLIP(pcfg)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    assert port.logit_scale.shape == () and port.proj_a.layer_scale.shape == (1,)
    np.testing.assert_array_equal(port.proj_b.fc0.kernel.detach().numpy(),
                                  np.asarray(params["proj_b"]["fc0"]["kernel"]).T)


def test_config_rejects_unported_fields():
    with pytest.raises(KeyError):
        pconfig.apply_overrides(pconfig.Config(), ["contrastive.gather_global_batch=true"])
    with pytest.raises(ValueError):
        build_model(dataclasses.replace(pconfig.Config(), experiment="no_such_experiment"))
    with pytest.raises(ValueError, match="unknown tower architecture"):
        build_model(pconfig.apply_overrides(pconfig.Config(), ["tower_a.architecture=conv"]))


def test_train_cli_one_epoch(capsys, tmp_path):
    hist = train_cli.main(["--device", "cpu", "--epochs", "1",
                           *sum((["-o", o] for o in SMALL + FUSED), []),
                           "-o", "train.batch_size=128", "-o", f"logging.log_dir={tmp_path}"])
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])
    assert np.isfinite(hist["val_loss"][0])
    assert '"done": true' in capsys.readouterr().out
