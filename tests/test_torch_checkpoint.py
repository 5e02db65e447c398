"""The port's checkpoints, preemption saves and metric logger
(clip_dplm_tpu_torch: train/checkpoint.py, train/preemption.py, the Trainer
of train/trainer.py, utils/logging.py, utils/convert.py
`load_flax_train_state`, the train CLI's --resume) against the JAX package.

- Resume within the port, one case per family (the cached two-tower: cache,
  cache_ptr, cache_len; DPLM with LoRA: frozen leaves without moments, bf16
  moments; the `stale` clip: prev_norm; triple_flow, whose flows draw from
  the key), saved synchronously and asynchronously with a step taken right
  after `save()`: N steps, save, restore into a state built from another
  seed, M steps, against N + M steps without a break (N = M = 2; 1 and 1
  for triple_flow, whose steps are the slowest here): every parameter,
  moment, count, prev_norm, step, key, cache leaf and loss equal bit for
  bit.
- keep=2 and Orbax's skip of a step at or below the latest; strict restore.
- Resume parity with JAX on the cached two-tower at f32, dropout 0: JAX
  saves with its own CheckpointManager at step 2, restores and takes 2
  steps; the port loads JAX's step-2 state, saves and restores through its
  own manager and takes the same 2 steps. With the plain loss: loss rtol
  1e-4, parameters atol 1e-5, moments atol 1e-5 / rtol 1e-4, cache atol
  1e-6, as tests/test_torch_two_tower.py and test_torch_cache.py hold the
  steps; on the `two_tower_optimized` preset (the fused loss) the losses and
  the cache (atol 1e-5), as test_torch_cache.py holds that route.
- JAX's masked LoRA optimizer state carried across exactly.
- The Trainer's save policy and preemption against JAX's Trainer: the steps
  kept with keep=2 over 4 epochs, `guard.request()` after step k, and a real
  SIGTERM from inside the port's loop.
- The train CLI: --resume, metrics.csv with JAX's header, config.yaml.
- The profiler hook (a Chrome trace of its step range) and the step timer.
"""

import csv
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.experiments.registry import build_model as jax_build_model
from clip_dplm_tpu.train import PreemptionGuard as JaxPreemptionGuard
from clip_dplm_tpu.train import Trainer as JaxTrainer
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train import state as jstate
from clip_dplm_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from clip_dplm_tpu.utils.logging import MetricLogger as JaxMetricLogger
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.experiments import train as train_cli
from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
from clip_dplm_tpu_torch.models.clip import TwoTowerCLIP
from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager
from clip_dplm_tpu_torch.train.preemption import PreemptionGuard
from clip_dplm_tpu_torch.train.state import build_optimizer, create_train_state
from clip_dplm_tpu_torch.train.trainer import Trainer, make_train_step, to_device
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_train_state
from clip_dplm_tpu_torch.utils.logging import ProfilerHook, StepTimer
from clip_dplm_tpu_torch.utils.pretrained import read_config
from test_torch_two_tower import STEP, _batch, _pair, fused_jax  # noqa: F401

TT = ["tower_a.input_dim=24", "tower_a.hidden_size=64", "tower_a.num_hidden_layers=2",
      "tower_b.input_dim=40", "tower_b.hidden_size=64", "tower_b.num_hidden_layers=2",
      "projection.dim=32", "projection.hidden_dim=64", "train.batch_size=32"]
DPLM_LORA = ["experiment=dplm", "dplm.d_model=64", "dplm.num_layers=2", "dplm.num_heads=2",
             "dplm.lora_rank=2", "train.batch_size=8", "train.optim.moment_dtype=bfloat16"]
FAMILIES = {
    "cached_two_tower": TT + ["contrastive.use_cache=true", "contrastive.cache_size=80"],
    "dplm_lora_bf16_moments": DPLM_LORA,
    "stale_clip": TT + ["train.optim.clip_mode=stale", "train.optim.grad_clip_norm=0.5"],
    "triple_flow": ["experiment=triple_flow", "train.batch_size=12", "encoders.latent_dim=32",
                    "encoders.gene_dim=24", "encoders.esm_dim=20", "encoders.time_embed_dim=8",
                    "encoders.protein_hidden_dims=[24,16]", "encoders.gnn.num_layers=2",
                    "encoders.gnn.num_heads=4", "flow.latent_dim=32", "flow.hidden_dim=48",
                    "flow.time_embed_dim=8"],
}
CONST = ["train.optim.schedule=constant", "train.optim.learning_rate=1e-3"]
SPLIT = {"triple_flow": (1, 1)}  # (N, M) where not (2, 2)


def _cfg(over, seed=0):
    return pconfig.apply_overrides(pconfig.Config(), over + CONST + [f"train.seed={seed}"])


def _state(cfg):
    return create_train_state(build_model(cfg, device="cpu", dtype=torch.float32), cfg)


def _batches(cfg, n):  # the registry caches each family's data
    train, _ = build_data(cfg)
    it = train(seed=1)
    return [next(it) for _ in range(n)]


def _assert_same_state(a, b):
    for (k, x), (k2, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert k == k2 and torch.equal(x, y), k
    oa, ob = a.opt_state, b.opt_state
    for attr in ("mu", "nu"):
        ma, mb = getattr(oa, attr), getattr(ob, attr)
        assert ma.keys() == mb.keys()
        for k in ma:
            assert ma[k].dtype == mb[k].dtype and torch.equal(ma[k], mb[k]), (attr, k)
    assert oa.count == ob.count and torch.equal(oa.prev_norm, ob.prev_norm)
    assert (a.step, a.key) == (b.step, b.key)
    for k in ("cache", "cache_ptr", "cache_len"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None and y is None) or torch.equal(x, y), k


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_resume_is_bit_exact(family, async_save, tmp_path):
    n, m = SPLIT.get(family, (2, 2))
    cfg = _cfg(FAMILIES[family])
    batches = [to_device(b, "cpu") for b in _batches(cfg, n + m)]
    step = make_train_step(cfg)
    straight = _state(cfg)
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    losses = []
    for i, b in enumerate(batches):
        straight, metrics = step(straight, b)
        losses.append(metrics["loss"])
        if i == n - 1:
            # with async_save the next step's in-place updates run while the
            # write may be in flight
            assert mgr.save(straight, straight.step)
    resumed = _state(_cfg(FAMILIES[family], seed=7))
    assert resumed.key != straight.key
    mgr.restore(resumed)
    assert resumed.step == n and resumed.opt_state.count == n
    for i, b in enumerate(batches[n:]):
        resumed, metrics = step(resumed, b)
        assert torch.equal(metrics["loss"], losses[n + i])
    _assert_same_state(straight, resumed)
    # what each family is there to cover
    opt = straight.opt_state
    if family == "cached_two_tower":
        # B=32 in 80 rows: the third step's rows do not fit past row 64, so the
        # ring went back to row 0 (the high-water mark stays at 64)
        assert (int(straight.cache_ptr), int(straight.cache_len)) == (64, 64)
    if family == "dplm_lora_bf16_moments":
        assert straight.tx.mask_moments and "layer_0.q.kernel" not in opt.mu
        assert {v.dtype for v in opt.mu.values()} == {torch.bfloat16}
    if family == "stale_clip":
        assert float(opt.prev_norm) > 0


def test_keep_last_and_skip_of_an_older_step(tmp_path):
    cfg = _cfg(FAMILIES["stale_clip"])
    st = _state(cfg)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        st.step = s
        assert mgr.save(st, s)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pt", "ckpt_4.pt"]
    assert not mgr.save(st, 4) and not mgr.save(st, 2)  # at or below the latest, as Orbax
    saved = torch.load(tmp_path / "ckpt_4.pt", weights_only=True)
    assert set(saved) == {"step", "key", "params", "opt_state"}
    assert set(saved["opt_state"]) == {"count", "mu", "nu", "prev_norm"}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(st)


def _lora_full_state(cfg):
    """The LoRA DPLM with a plain optimizer: moments for every leaf."""
    return create_train_state(build_model(cfg, device="cpu", dtype=torch.float32), cfg,
                              tx=build_optimizer(cfg.train.optim))


@pytest.mark.parametrize("case", ["cached_into_uncached", "lora_into_full", "shape",
                                  "moment_dtype"])
def test_restore_is_strict(case, tmp_path):
    cached = _cfg(FAMILIES["cached_two_tower"])
    lora = _cfg(DPLM_LORA)
    saved_cfg, into, match = {
        "cached_into_uncached": (cached, lambda: _state(_cfg(TT)), "cache"),
        "lora_into_full": (lora, lambda: _lora_full_state(lora),
                           r"opt_state\.mu\.layer_0\.q\.kernel"),
        "shape": (cached, lambda: _state(_cfg(FAMILIES["cached_two_tower"]
                                              + ["tower_a.hidden_size=32"])),
                  r"params\.tower_a\."),
        "moment_dtype": (lora, lambda: _state(_cfg(DPLM_LORA[:-1])),
                         r"opt_state\.mu\..*bfloat16"),
    }[case]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(saved_cfg), 1)
    with pytest.raises((KeyError, ValueError), match=match):
        mgr.restore(into())


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

CACHED = ["contrastive.use_cache=true", "contrastive.cache_size=80"]


def _jnp(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _jax_state(jm, jcfg, params, batch):
    js = jax_create_train_state(jm, jcfg, _jnp(batch))
    return js.replace(params=params, opt_state=js.tx.init(params))


def _jax_moments(tree):
    """A JAX moment tree as the port's names and layout (Dense kernels
    (out, in)); `optax.masked`'s empty MaskedNode leaves are no leaves."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(p.key) for p in path)
        arr = np.asarray(leaf)
        flat[name] = arr.T if name.endswith("kernel") else arr
    return flat


@pytest.mark.parametrize("loss", ["plain", "fused"])
def test_resume_matches_jax(request, loss, tmp_path):
    """The cached two-tower with the plain loss, and the `two_tower_optimized`
    preset (the fused loss; JAX's in interpret mode). The fused loss's bf16
    similarity operands let a near-zero gradient's sign differ between the
    packages and move a leaf by +-lr (tests/test_torch_two_tower.py), so on
    the preset the losses and the cache are held, as test_torch_cache.py
    holds them (cache atol 1e-5), and the parameters and moments are not."""
    fused = loss == "fused"
    if fused:
        request.getfixturevalue("fused_jax")
    extra = CACHED + (["contrastive.use_fused_kernel=true"] if fused else [])
    jcfg, pcfg, jm, params, port = _pair(STEP + extra, jnp.float32, torch.float32)
    batches = [_batch(32, seed=s) for s in range(4)]
    jstep = jax.jit(jax_make_train_step(jcfg))
    js = _jax_state(jm, jcfg, params, batches[0])
    for b in batches[:2]:
        js, _ = jstep(js, _jnp(b))
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"))
    jmgr.save(js, 2)
    js = jmgr.restore(_jax_state(jm, jcfg, params, batches[0]))

    carried = load_flax_train_state(create_train_state(port, pcfg, init=False), js)
    assert carried.step == 2 and carried.opt_state.count == 2
    pmgr = CheckpointManager(str(tmp_path / "port"))
    pmgr.save(carried, carried.step)
    pst = create_train_state(TwoTowerCLIP(pcfg, dtype=torch.float32), pcfg)  # other weights
    pmgr.restore(pst)
    pstep = make_train_step(pcfg)
    for b in batches[2:]:
        js, jmet = jstep(js, _jnp(b))
        pst, pmet = pstep(pst, to_device(b, "cpu"))
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]), rtol=1e-4)
    assert pst.opt_state.count == int(js.opt_state.count) == pst.step == 4
    assert (int(pst.cache_ptr), int(pst.cache_len)) == (int(js.cache_ptr),
                                                        int(js.cache_len)) == (64, 64)
    np.testing.assert_allclose(pst.cache.numpy(), np.asarray(js.cache), rtol=0,
                               atol=1e-5 if fused else 1e-6)
    if fused:
        return
    want = flax_to_state_dict(js.params)
    for k, v in pst.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
    for attr in ("mu", "nu"):
        jmom = _jax_moments(getattr(js.opt_state, attr))
        assert jmom.keys() == pst.opt_state.mu.keys()
        for k, v in getattr(pst.opt_state, attr).items():
            np.testing.assert_allclose(v.numpy(), jmom[k], atol=1e-5, rtol=1e-4,
                                       err_msg=f"{attr} {k}")


def test_masked_lora_optimizer_state_carries_across():
    """JAX's LoRA optimizer is optax.masked inside freeze_subtrees' chain:
    its moments (filled here with numpy draws) land on the port's trained
    leaves exactly, in bf16, and the frozen leaves have none on either side."""
    jcfg = jconfig.apply_overrides(jconfig.Config(), DPLM_LORA)
    pcfg = _cfg(DPLM_LORA)
    rng = np.random.default_rng(0)
    fill = lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype)  # noqa: E731
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(fill, shapes)
    frozen = [k for k in params if k.startswith("layer_") or k == "embed_tokens"]
    tx = jstate.freeze_subtrees(jstate.build_optimizer(jcfg.train.optim), params, frozen)
    masked, rest = tx.init(params)[0], tx.init(params)[1:]
    adam = masked.inner_state
    adam = adam.replace(mu=jax.tree_util.tree_map(fill, adam.mu),
                        nu=jax.tree_util.tree_map(lambda x: abs(fill(x)), adam.nu),
                        count=jnp.int32(5), prev_norm=jnp.float32(0.25))
    js = {"step": jnp.int32(5), "params": params,
          "opt_state": (masked._replace(inner_state=adam), *rest)}
    pst = create_train_state(build_model(pcfg, device="cpu", dtype=torch.float32), pcfg,
                             init=False)
    load_flax_train_state(pst, js)
    assert (pst.step, pst.opt_state.count, float(pst.opt_state.prev_norm)) == (5, 5, 0.25)
    for attr in ("mu", "nu"):
        want = _jax_moments(getattr(adam, attr))
        have = getattr(pst.opt_state, attr)
        assert have.keys() == want.keys() and "layer_0.q.kernel" not in have
        for k, v in have.items():
            assert v.dtype == torch.bfloat16
            np.testing.assert_array_equal(v.float().numpy(), want[k].astype(np.float32))
    np.testing.assert_array_equal(pst.model.state_dict()["lm_head.kernel"].numpy(),
                                  np.asarray(params["lm_head"]["kernel"]).T)


# the policy runs: 3 train batches an epoch, 2 validation batches, a learning
# rate that lets the validation loss rise in some epochs
POLICY = ["train.optim.learning_rate=3e-2", "train.keep_checkpoints=2"]


def _policy_pair(extra=()):
    jcfg, pcfg, jm, params, port = _pair(STEP + POLICY + list(extra), jnp.float32,
                                         torch.float32)
    train = [_batch(32, seed=s) for s in range(3)]
    val = [_batch(32, seed=10 + s) for s in range(2)]
    js = _jax_state(jm, jcfg, params, train[0])
    return jcfg, pcfg, js, create_train_state(port, pcfg, init=False), train, val


def _orbax_steps(directory):
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def _after_step(trainer, k, action):
    """Run `action` right after the trainer's k-th train step."""
    inner, calls = trainer.train_step, [0]

    def step(state, batch):
        out = inner(state, batch)
        calls[0] += 1
        if calls[0] == k:
            action()
        return out

    trainer.train_step = step


def test_trainer_save_policy_matches_jax(tmp_path):
    jcfg, pcfg, js, pst, train, val = _policy_pair()
    jt = JaxTrainer(jcfg, js, checkpoint_dir=str(tmp_path / "jax"))
    jh = jt.train(lambda: iter(train), lambda: iter(val), num_epochs=4)
    pt = Trainer(pcfg, pst, checkpoint_dir=str(tmp_path / "port"))
    ph = pt.train(lambda: iter(train), lambda: iter(val), num_epochs=4)
    np.testing.assert_allclose(ph["val_loss"], jh["val_loss"], rtol=1e-4)
    best = [i for i, v in enumerate(jh["val_loss"]) if v < min(jh["val_loss"][:i], default=1e9)]
    kept = [3 * (i + 1) for i in best][-2:]
    assert _orbax_steps(tmp_path / "jax") == kept
    assert CheckpointManager(str(tmp_path / "port")).all_steps() == kept
    assert len(best) < 4  # some epoch was not a new best


@pytest.fixture(scope="module")
def jax_preempted(tmp_path_factory):
    """JAX's Trainer preempted with guard.request() after step 5 (the
    second epoch): its history and the steps in its checkpoint dir."""
    jcfg, _, js, _, train, val = _policy_pair()
    directory = tmp_path_factory.mktemp("jax_preempted")
    jt = JaxTrainer(jcfg, js, checkpoint_dir=str(directory))
    jguard = JaxPreemptionGuard()
    _after_step(jt, 5, jguard.request)
    jh = jt.train(lambda: iter(train), lambda: iter(val), num_epochs=4,
                  preemption_guard=jguard)
    return jh, _orbax_steps(directory)


@pytest.mark.parametrize("how", ["request", "sigterm"])
def test_preemption_matches_jax(how, jax_preempted, tmp_path):
    """The port's Trainer preempted after step 5 with guard.request(), or
    with a real SIGTERM that the guard it installs catches, against JAX's
    with guard.request()."""
    jh, jax_steps = jax_preempted
    _, pcfg, _, pst, train, val = _policy_pair()
    pt = Trainer(pcfg, pst, checkpoint_dir=str(tmp_path / "port"))
    before = signal.getsignal(signal.SIGTERM)
    if how == "request":
        guard = PreemptionGuard()
        _after_step(pt, 5, guard.request)
        ph = pt.train(lambda: iter(train), lambda: iter(val), num_epochs=4,
                      preemption_guard=guard)
    else:
        _after_step(pt, 5, lambda: os.kill(os.getpid(), signal.SIGTERM))
        ph = pt.train(lambda: iter(train), lambda: iter(val), num_epochs=4)
    assert signal.getsignal(signal.SIGTERM) == before  # the Trainer's guard is gone
    assert jh["preempted_at_step"] == ph["preempted_at_step"] == [5]
    assert jax_steps == [3, 5]
    assert CheckpointManager(str(tmp_path / "port")).all_steps() == [3, 5]
    assert pt.state.step == 5 and len(ph["train_loss"]) == 1


def test_train_cli_resume_metrics_csv_and_config(tmp_path, capsys):
    over = TT + ["train.batch_size=512", f"logging.log_dir={tmp_path}"]
    argv = ["--device", "cpu", "--epochs", "1", *[a for o in over for a in ("-o", o)]]
    train_cli.main(argv)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.all_steps() == [3]  # 1740 pairs: 3 batches of 512 (no validation batch)
    capsys.readouterr()
    train_cli.main(argv + ["--resume"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines[1]["resumed_from_step"] == 3
    assert lines[-1]["step"] == 6 and ckpt.all_steps() == [3, 6]
    with open(tmp_path / "metrics.csv") as f:
        rows = list(csv.reader(f))
    JaxMetricLogger(str(tmp_path / "jax")).log(0, {"train_loss": 1.0, "val_loss": 1.0,
                                                   "epoch_seconds": 1.0})
    with open(tmp_path / "jax" / "metrics.csv") as f:
        jax_header = next(csv.reader(f))
    assert rows[0] == jax_header == ["step", "time", "train_loss", "val_loss", "epoch_seconds"]
    assert [r[0] for r in rows[1:]] == ["0", "0"]  # one epoch a run, appended
    assert read_config(str(tmp_path / "config.yaml")) == pconfig.apply_overrides(
        pconfig.Config(), over)
    with open(tmp_path / "train.log") as f:
        assert f"resumed from step 3 in {tmp_path / 'ckpt'}" in f.read()


def test_profiler_hook_and_step_timer(tmp_path):
    """The hook starts after step 2 and writes the trace of steps 3-4 after
    step 4; the timer skips its warmup ticks."""
    hook, timer = ProfilerHook(str(tmp_path), start_step=2, num_steps=2), StepTimer(warmup=1)
    x = torch.ones(8, 8)
    for step in range(1, 7):
        x = x @ x / 8
        hook.step(step)
        timer.tick()
        if step == 3:
            assert not os.path.exists(tmp_path / "trace_steps_2_4.json")
    hook.close()  # nothing in progress
    with open(tmp_path / "trace_steps_2_4.json") as f:
        trace = json.load(f)
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])
    assert len(timer.times) == 4 and timer.mean > 0
