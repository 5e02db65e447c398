"""The port's triple_flow family (clip_dplm_tpu_torch: models/
triple_flow_model.py, the trainer's loss and eval, the registry entry,
utils/convert.py and the train CLI) against the JAX package on the same
numpy weights and batch, in f32 at small widths (latent 32, gene_dim 24,
esm_dim 20, two PiGNN layers of 4 heads, 24 cells from the host pipeline).
JAX's PRNG draws cannot be matched, so both sides get the same flow draws:
the module attribute `sample_location_and_conditional_flow` of each
package's flows module is replaced by one that pairs by each package's own
exact OT and takes t and eps from a fixed numpy table (one row per flow, in
call order). Checked: the forward's latents and flows and
`compute_all_losses` (rtol 1e-4 / atol 1e-5, the reference's metric names);
the three generate calls; every leaf's gradient of one step (atol 1e-5 +
1e-4 of the leaf's largest entry) and the loss of three train steps; the
deterministic eval; two steps of the train CLI on the CPU; the refusal of
grad_accum_steps > 1; f32 whatever dtype is asked; the step's FLOP count
against the model's Dense shapes."""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.models import flows as jflows
from clip_dplm_tpu.models import triple_flow_model as jtfm
from clip_dplm_tpu.ops import sinkhorn as jsk
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_eval_step as jax_make_eval_step
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train import trainer as jtrainer
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.experiments import train as train_cli
from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
from clip_dplm_tpu_torch.models import flows as pflows
from clip_dplm_tpu_torch.models import triple_flow_model as ptfm
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.train import trainer as ptrainer
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params
from test_torch_esm import rng_params
from test_torch_ot_flows import ENC
from test_torch_segment_gnn import F32

SMALL = ["experiment=triple_flow", "train.batch_size=24", "contrastive.temperature=0.1",
         "train.optim.schedule=constant", "train.optim.learning_rate=1e-3"] + ENC
B, D = 24, 32


def _cfgs(extra=()):
    return (jconfig.apply_overrides(jconfig.Config(), SMALL + list(extra)),
            pconfig.apply_overrides(pconfig.Config(), SMALL + list(extra)))


DRAW_RNG = np.random.default_rng(11)
T_TABLE = DRAW_RNG.random((4, B)).astype(np.float32)
EPS_TABLE = DRAW_RNG.normal(size=(4, B, D)).astype(np.float32)


def _fixed_draws(monkeypatch):
    """Both packages' conditional flow: each side's exact pairing, t and
    eps from the fixed table, row i % 4 on the i-th call."""
    jcalls, pcalls = itertools.count(), itertools.count()

    def jax_draw(key, x0, x1, flow_type="exact_ot", sigma=0.1, sinkhorn_iters=100):
        i = next(jcalls) % 4
        idx = jsk.ot_pairing(key, x0, x1, method="exact")
        x1 = x1[idx]
        tt = jnp.asarray(T_TABLE[i])[:, None]
        xt = (1.0 - tt) * x0 + tt * x1 + sigma * jnp.asarray(EPS_TABLE[i])
        return jnp.asarray(T_TABLE[i]), xt, x1 - x0

    def port_draw(seeds, x0, x1, flow_type="exact_ot", sigma=0.1, sinkhorn_iters=100):
        i = next(pcalls) % 4
        for _ in range(4):
            seeds.next()
        idx = pflows.pairing_indices(x0, x1, flow_type, sigma, sinkhorn_iters, None)
        tt, xt, ut = pflows.sample_location_and_conditional_flow_from_draw(
            x0, x1, idx, torch.from_numpy(T_TABLE[i]), torch.from_numpy(EPS_TABLE[i]),
            flow_type, sigma)
        return tt, xt, ut, idx

    monkeypatch.setattr(jflows, "sample_location_and_conditional_flow", jax_draw)
    monkeypatch.setattr(pflows, "sample_location_and_conditional_flow", port_draw)


@pytest.fixture(scope="module")
def batches():
    _, pcfg = _cfgs()
    train, _ = build_data(pcfg)
    return list(itertools.islice(train(seed=3), 3))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def params(batches):
    """The JAX model's param tree (its shapes traced, not compiled), every
    leaf drawn with numpy."""
    jm = jtfm.TripleFlowModel(cfg=_cfgs()[0])
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1), b),
                            _jnp(batches[0]))["params"]
    return rng_params(shapes, np.random.default_rng(5))


def _pair(monkeypatch, params, extra=()):
    _fixed_draws(monkeypatch)
    jcfg, pcfg = _cfgs(extra)
    jm = jtfm.TripleFlowModel(cfg=jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    port = load_flax_params(build_model(pcfg, dtype=torch.bfloat16), params)
    return jcfg, pcfg, jm, params, port


def test_forward_and_losses_match_jax(monkeypatch, batches, params):
    jcfg, pcfg, jm, params, port = _pair(monkeypatch, params)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    jout = jax.jit(lambda p, b: jm.apply({"params": p}, jax.random.PRNGKey(2), b))(
        params, _jnp(batches[0]))
    pout = port(ptrainer.to_device(batches[0], "cpu"), DropoutSeeds(0, 0))
    for k, v in jout["embeddings"].items():
        np.testing.assert_allclose(pout["embeddings"][k].detach().numpy(), np.asarray(v),
                                   **F32, err_msg=k)
    assert set(pout["flows"]) == set(jout["flows"]) == {
        "cell_to_pert", "cell_to_protein", "pert_to_protein", "cell_to_cell"}
    for name, f in jout["flows"].items():
        for k in ("v", "xt", "ut", "regularization"):
            np.testing.assert_allclose(pout["flows"][name][k].detach().numpy(),
                                       np.asarray(f[k]), **F32, err_msg=f"{name}.{k}")
    jl, jmet = jtfm.compute_all_losses(jout, jcfg)
    pl, pmet = ptfm.compute_all_losses(pout, pcfg)
    np.testing.assert_allclose(float(pl.detach()), float(jl), **F32)
    assert set(pmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(pmet[k].detach()), float(jmet[k]), **F32, err_msg=k)


def test_generation_matches_jax(monkeypatch, params):
    _, _, jm, params, port = _pair(monkeypatch, params)
    x = np.random.default_rng(8).normal(size=(6, D)).astype(np.float32)
    for fn, args in (("generate_cell_trajectory", (x, x, 5, "heun")),
                     ("generate_protein_from_cell", (x, 5, "rk4")),
                     ("generate_pert_from_cell", (x, 4, "euler"))):
        jx, jtraj = jm.apply({"params": params}, *[jnp.asarray(a) if isinstance(a, np.ndarray)
                                                    else a for a in args],
                             method=getattr(jtfm.TripleFlowModel, fn))
        px, ptraj = getattr(port, fn)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                                        else a for a in args])
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), **F32, err_msg=fn)
        np.testing.assert_allclose(ptraj.numpy(), np.asarray(jtraj), **F32, err_msg=fn)


def test_three_train_steps_match_jax(monkeypatch, batches, params):
    """Dropout 0: every leaf's gradient of the first step before the
    optimizer, then the loss of three steps and the eval from the same
    weights and batches."""
    jcfg, pcfg, jm, params, port = _pair(monkeypatch, params)
    jloss = jtrainer._triple_flow_loss_fn(jcfg)
    want = flax_to_state_dict(jax.jit(jax.grad(lambda p, b: jloss(
        p, jm.apply, b, jax.random.PRNGKey(0), None, None)[0]))(params, _jnp(batches[0])))
    loss, (metrics, emb_b) = ptrainer.make_loss_fn(pcfg)(
        port, ptrainer.to_device(batches[0], "cpu"), DropoutSeeds(0, 0))
    assert emb_b is None and {"flow_cell_to_cell", "reg_cell_to_cell",
                              "loss_cell_emb_pert_emb"} <= set(metrics)
    loss.backward()
    assert set(want) == {k for k, _ in port.named_parameters()}
    unused = set()
    for k, p in port.named_parameters():
        w = want[k].numpy()
        if p.grad is None:  # the PiGNN's edge state feeds no node: no gradient
            unused.add(k)
            assert not w.any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(), err_msg=k)
    assert unused and all(".edge_mlp_" in k or ".ln_edge." in k for k in unused), unused
    port.zero_grad()
    # JAX's state around the same params (its own init, eager, is not rerun)
    js = jax_create_train_state(types.SimpleNamespace(
        init=lambda *a, **k: {"params": params}, apply=jm.apply), jcfg, _jnp(batches[0]))
    jstep = jax.jit(jax_make_train_step(jcfg))
    pst = create_train_state(port, pcfg, init=False)
    pstep = ptrainer.make_train_step(pcfg)
    for b in batches:
        js, jmetrics = jstep(js, _jnp(b))
        pst, pm = pstep(pst, ptrainer.to_device(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    assert pst.step == 3
    jev = jax.jit(jax_make_eval_step(jcfg))(js, _jnp(batches[0]))
    pev = ptrainer.make_eval_step(pcfg)(pst, ptrainer.to_device(batches[0], "cpu"))
    assert set(pev) == set(jev)
    np.testing.assert_allclose(float(pev["loss"]), float(jev["loss"]), rtol=1e-4)


def test_eval_is_deterministic_given_the_state(batches):
    _, pcfg = _cfgs()
    st = create_train_state(build_model(pcfg), pcfg)
    b = ptrainer.to_device(batches[0], "cpu")
    ev = ptrainer.make_eval_step(pcfg)
    first, again = ev(st, b), ev(st, b)
    assert st.step == 0 and all(torch.equal(first[k], again[k]) for k in first)


def test_train_cli_two_steps(tmp_path):
    hist = train_cli.main(["--device", "cpu", "--epochs", "1",
                           *sum((["-o", o] for o in SMALL), []),
                           "-o", "train.batch_size=400", "-o", "encoders.dropout=0.1",
                           "-o", f"logging.log_dir={tmp_path}"])
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])


def test_grad_accum_is_refused():
    _, pcfg = _cfgs(["train.optim.grad_accum_steps=2"])
    with pytest.raises(ValueError, match="grad_accum_steps > 1 is not supported for triple_flow"):
        ptrainer.make_train_step(pcfg)


def test_yaml_fields_parse():
    """Every triple_flow field of configs/triple_flow.yaml the family reads
    takes an override; a field it does not read is refused."""
    cfg = pconfig.apply_overrides(pconfig.Config(), [
        "experiment=triple_flow", "encoders.gnn.num_layers=2",
        "encoders.use_cross_attention=false",
        "encoders.protein_hidden_dims=[64,32]", "flow.flow_type=sb", "flow.sinkhorn_iters=10",
        "flow.use_feature_mixing=true", "icnn.hidden_dims=[8,4]", "icnn.activation=celu",
        "train.loss_weights.regularization=0.5", "data.n_top_genes=100",
        "data.augment.edge_dropout=0.2"])
    assert cfg.encoders.protein_hidden_dims == (64, 32) and cfg.icnn.hidden_dims == (8, 4)
    assert cfg.encoders.gnn.num_layers == 2 and cfg.flow.sinkhorn_iters == 10
    for unread in ("flow.sinkhorn_epsilon=0.5", "encoders.gnn.n_neighbors=16",
                   "icnn.hessian_reg=0.1"):
        with pytest.raises(KeyError):
            pconfig.apply_overrides(pconfig.Config(), [unread])
    assert cfg.train.loss_weights.regularization == 0.5 and cfg.data.augment.edge_dropout == 0.2
    assert pconfig.Config().flow == pconfig.FlowConfig()
    assert pconfig.Config().encoders.gnn.num_heads == 8


def test_step_flops_count_the_dense_layers(batches):
    """`triple_flow_step_flops` is 3x the training forward's matmuls: every
    Dense the forward calls (2·rows·in·out) but the PiGNN's edge MLP, whose
    output reaches no loss, and the three InfoNCE and four OT B x B
    products."""
    from clip_dplm_tpu_torch.models.layers import Dense

    _, pcfg = _cfgs()
    model = create_train_state(build_model(pcfg), pcfg).model
    counted, edge_mlp = [0.0], []

    def hook(mod, inp, out):
        counted[0] += 2.0 * inp[0].numel() * mod.kernel.shape[0]

    for name, m in model.named_modules():
        if isinstance(m, Dense):
            if ".edge_mlp_" in name:
                edge_mlp.append(name)
            else:
                m.register_forward_hook(hook)
    assert len(edge_mlp) == 2 * pcfg.encoders.gnn.num_layers
    b = ptrainer.to_device(batches[0], "cpu")
    with torch.no_grad():
        model(b, DropoutSeeds(0, 0))
    n, E = b["gene_expr"].shape[0], b["edge_index"].shape[1]
    fwd = counted[0] + 3 * 2.0 * n * n * pcfg.encoders.latent_dim \
        + 4 * 2.0 * n * n * pcfg.flow.latent_dim
    np.testing.assert_allclose(ptfm.triple_flow_step_flops(pcfg, n, E), 3.0 * fwd, rtol=1e-12)
