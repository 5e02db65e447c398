"""The port's probe classifiers and ablation harness
(clip_dplm_tpu_torch/models/classifiers.py) against the JAX package's on
the same numpy features and converted params, in f32 on the CPU:

- the four probes' deterministic forwards and the gradient of every leaf
  (and of the input) at rtol 1e-5, atol 1e-5 of the output's largest entry
  (entries near 0), on params carried across by `load_flax_params` with no
  mapping of their own (the submodules carry flax's auto-names); the
  transformer probe's two f32 blocks take the tiny-S path's plain version;
- `train_probe` from JAX's initial params for linear, simple_nonlinear and
  mlp with dropout 0, 50 Adam steps on the same draws of batches: every
  param within atol 1e-5 / rtol 1e-4 of JAX's, but for the weights of a
  ReLU unit whose pre-activation came within f32 rounding of 0 (one here:
  the sample's gradient then lands on one side only; the test finds it and
  allows at most one) (the transformer probe's
  dropout cannot be turned off, so it is held by its forward and gradient);
- `ablation_study` over all four probes reaches the JAX suite's thresholds
  (tests/test_analysis_suite.py: above 0.7 on two clusters after 80 steps,
  above 0.8 for linear and mlp on three after 100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_dplm_tpu.models import classifiers as jcls
from clip_dplm_tpu_torch.models import classifiers as pcls
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for these small CPU ops (the suite runs six xdist
    workers on the host's cores; a probe's 80 steps took 2x as long on
    eight threads as on one, alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered_embeddings(rng, n=60, d=16, k=3):
    centers = rng.normal(size=(k, d)).astype(np.float32) * 3
    labels = rng.integers(0, k, n)
    emb = centers[labels] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    return emb, labels


def _jax_init(probe, x, seed=0):
    return probe.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed)},
                      jnp.asarray(x[:2]))["params"]


def _close(got, want, name, rtol=1e-5, rel_atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel_atol * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("name", ["linear", "simple_nonlinear", "mlp", "transformer"])
def test_probe_forward_and_gradients_match_jax(name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 48)).astype(np.float32)
    w = rng.normal(size=(12, 5)).astype(np.float32)
    jprobe = jcls.PROBES[name](num_classes=5)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32), _jax_init(jprobe, x))

    def jloss(p, xx):
        return jnp.sum(jprobe.apply({"params": p}, xx, deterministic=True) * w)

    want = jax.jit(lambda p, xx: jprobe.apply({"params": p}, xx, deterministic=True))(
        params, jnp.asarray(x))
    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    port = load_flax_params(pcls.PROBES[name](num_classes=5, in_features=48), params)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = port(tx, deterministic=True)
    assert got.dtype == torch.float32 and got.shape == (12, 5)
    _close(got.detach().numpy(), want, "logits")
    torch.sum(got * torch.from_numpy(w)).backward()
    want_g = flax_to_state_dict(jg)
    assert set(want_g) == {k for k, _ in port.named_parameters()}
    for k, p in port.named_parameters():
        _close(p.grad.numpy(), want_g[k].numpy(), k)
    _close(tx.grad.numpy(), jgx, "dx")


@pytest.mark.parametrize("name", ["linear", "simple_nonlinear", "mlp"])
def test_train_probe_matches_jax(name):
    rng = np.random.default_rng(1)
    x, y = _clustered_embeddings(rng, n=90, d=20, k=4)
    kw = {"dropout": 0.0} if name == "mlp" else {}
    jprobe = jcls.PROBES[name](num_classes=4, **kw)
    init = _jax_init(jprobe, x)
    trained = jcls.train_probe(jprobe, x, y, num_steps=50, lr=1e-3, batch_size=32)
    want = flax_to_state_dict(trained)
    port = load_flax_params(pcls.PROBES[name](num_classes=4, in_features=20, **kw), init)
    # the smallest |pre-activation| each hidden ReLU unit saw over the steps
    closest = torch.full((256,), float("inf"))

    def watch(module, inputs, out):
        closest.copy_(torch.minimum(closest, out.detach().abs().amin(dim=0)))

    if name == "simple_nonlinear":
        port.Dense_0.register_forward_hook(watch)
    port = pcls.train_probe(port, x, y, num_steps=50, lr=1e-3, batch_size=32, device="cpu",
                            init=False)
    # a unit whose pre-activation came within f32 rounding of the ReLU's kink
    # takes that sample's gradient on one side and not on the other: its
    # weights are held apart (at most one such unit here: unit 201 between
    # steps 10 and 20), the rest at the bound
    kink = (closest < 1e-5).numpy()
    assert kink.sum() <= 1, np.flatnonzero(kink)
    for k, v in port.state_dict().items():
        got, w = v.numpy(), want[k].numpy()
        if name != "simple_nonlinear":
            pass
        elif k.startswith("Dense_0."):
            got, w = got[~kink], w[~kink]
        elif k == "Dense_1.kernel":
            got, w = got[:, ~kink], w[:, ~kink]
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-4, err_msg=k)
    assert pcls.evaluate_probe(port, x, y) == pytest.approx(
        jcls.evaluate_probe(jprobe, trained, x, y), abs=1 / 90)


def test_train_probe_draws_its_init_from_the_seed_on_the_cpu(monkeypatch):
    """The same seed gives the same initial weights and the same trained
    probe (drawn on the CPU, then moved to the device); the card is the
    default device."""
    rng = np.random.default_rng(2)
    x, y = _clustered_embeddings(rng, n=40, d=8, k=2)
    a = pcls.train_probe(pcls.MLPProbe(2, 8), x, y, num_steps=3, device="cpu", seed=5)
    b = pcls.train_probe(pcls.MLPProbe(2, 8), x, y, num_steps=3, device="cpu", seed=5)
    for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(u, v), k
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        pcls.train_probe(pcls.LinearProbe(2, 8), x, y, num_steps=1)


def test_ablation_study_reaches_the_jax_suites_thresholds():
    """On the JAX suite's data (each set drawn from a fresh default_rng(0),
    as its `rng` fixture gives it)."""
    emb, labels = _clustered_embeddings(np.random.default_rng(0), n=80, d=16, k=2)

    def variant():
        return {"train_x": emb[:60], "train_y": labels[:60],
                "test_x": emb[60:], "test_y": labels[60:]}

    grid = pcls.ablation_study({"base": variant}, num_classes=2, num_steps=80, device="cpu")
    assert set(grid["base"]) == {"linear", "simple_nonlinear", "mlp", "transformer"}
    for name, acc in grid["base"].items():
        assert acc > 0.7, (name, acc)
    emb, labels = _clustered_embeddings(np.random.default_rng(0), n=120, d=24, k=3)
    for name in ("linear", "mlp"):
        probe = pcls.train_probe(pcls.PROBES[name](num_classes=3, in_features=24), emb, labels,
                                 num_steps=100, device="cpu")
        assert pcls.evaluate_probe(probe, emb, labels) > 0.8, name


def test_adam_is_optax_adam():
    """torch.optim.Adam's update is optax.adam's (b1 0.9, b2 0.999, eps 1e-8)
    over ten steps of the same gradients."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(7, 3)).astype(np.float32)
    tx = optax.adam(1e-3)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([tp], lr=1e-3)
    for i in range(10):
        g = np.sin(p0 * (i + 1)).astype(np.float32) * (0.1 if i % 2 else 3.0)
        u, js = tx.update(jnp.asarray(g), js)
        jp = optax.apply_updates(jp, u)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
