"""The port's tf_clip three-way train path (clip_dplm_tpu_torch: models/
tf_clip.py, models/layers.py::VectorTransformerTower, the multiway losses,
train/trainer.py, the tf_clip registry entry, utils/convert.py and the train
CLI) against the JAX package on the same numpy weights and batches, at a
small size (d=64 so that Dh=8 under the fixed 8 heads, gene_dim 40, esm_dim
48, 10 DEG tokens): TFContrastiveModel in f32 (rtol 1e-4 / atol 1e-5) and
bf16 (rtol 0.05 / atol 0.03) with the cell tower on the tiny-S path (B=16)
and the packed short-S path (B=70); VectorTransformerTower and a two-tower
model with architecture=transformer the same way; every leaf's gradient of
one deterministic step (1e-4 of its largest entry) and the loss of three
steps (rtol 1e-4); the plain and fused multiway losses; the registry's
batches, connectivity included; strict conversion; one epoch of the train
CLI on the CPU; and the attention gate below 64 keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.models import TwoTowerCLIP as JaxTwoTowerCLIP
from clip_dplm_tpu.models import tf_clip as jtf
from clip_dplm_tpu.models.layers import VectorTransformerTower as JaxVectorTower
from clip_dplm_tpu.ops import infonce as jinfonce
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train import trainer as jtrainer
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.experiments import train as train_cli
from clip_dplm_tpu_torch.experiments.registry import build_data, knn_connectivity
from clip_dplm_tpu_torch.models.clip import TwoTowerCLIP
from clip_dplm_tpu_torch.models.layers import TransformerBlock, VectorTransformerTower
from clip_dplm_tpu_torch.models.tf_clip import TFContrastiveModel
from clip_dplm_tpu_torch.ops import infonce
from clip_dplm_tpu_torch.ops.attention import attention_reference, multihead_attention
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.ops.fused_infonce import fused_multiway_clip_loss
from clip_dplm_tpu_torch.train import trainer as ptrainer
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params
from test_torch_esm import rng_params

SMALL = ["experiment=tf_clip", "projection.dim=64", "projection.hidden_dim=128",
         "encoders.gene_dim=40", "encoders.esm_dim=48", "train.batch_size=16"]
STEP = ["projection.dropout=0.0", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"]
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.03)


def _cfgs(extra=()):
    return (jconfig.apply_overrides(jconfig.Config(), SMALL + list(extra)),
            pconfig.apply_overrides(pconfig.Config(), SMALL + list(extra)))


def _batch(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 41)).astype(np.float32)
    conn = knn_connectivity(x)
    conn[3], conn[:, 3] = 0.0, 0.0  # a cell with no neighbours: a masked key
    return {"cell_state": x, "connectivity": conn,
            "gene_esm": rng.normal(size=(n, 10, 48)).astype(np.float32),
            "gene_values": rng.uniform(-1, 1, (n, 10)).astype(np.float32),
            "protein_emb": rng.normal(size=(n, 48)).astype(np.float32)}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class _NoDropoutEncoder(jtf._Encoder):
    """The reference's encoder with its fixed 0.1 dropout at 0, for
    deterministic train steps."""

    dropout: float = 0.0


def _no_block_dropout(model):
    for m in model.modules():
        if isinstance(m, TransformerBlock):
            m.dropout = 0.0
    return model


def _pair(dtype_j, dtype_p, extra=(), n=16, seed=3):
    jcfg, pcfg = _cfgs(extra)
    jm = jtf.TFContrastiveModel(cfg=jcfg, dtype=dtype_j)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), _jnp(_batch(n)))["params"]
    params = dict(rng_params(params, np.random.default_rng(seed)), logit_scale=jnp.float32(2.6592))
    port = load_flax_params(TFContrastiveModel(pcfg, dtype=dtype_p), params)
    return jcfg, pcfg, jm, params, port


@pytest.mark.parametrize("n", [16, 70])  # cell tower: tiny-S, then packed short-S
@pytest.mark.parametrize("dtypes,tol", [((jnp.float32, torch.float32), F32),
                                        ((jnp.bfloat16, torch.bfloat16), BF16)])
def test_tf_clip_matches_flax(n, dtypes, tol):
    _, _, jm, params, port = _pair(*dtypes, n=n)
    batch = _batch(n)
    want = jax.jit(jm.apply)({"params": params}, _jnp(batch))
    with torch.no_grad():
        got = port(_torch(batch))
    for k in ("cell_embed", "pert_embed", "protein_embed"):
        assert got[k].dtype == torch.float32 and got[k].shape == (n, 64), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k], np.float32), err_msg=k,
                                   **tol)
    assert float(got["logit_scale"].detach()) == pytest.approx(float(want["logit_scale"]))


def _tower_cfg(**kw):
    base = dict(input_dim=24, hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
                architecture="transformer", dropout=0.0)
    base.update(kw)
    return jconfig.TowerConfig(**base), pconfig.TowerConfig(**base)


@pytest.mark.parametrize("dtypes,tol", [((jnp.float32, torch.float32), F32),
                                        ((jnp.bfloat16, torch.bfloat16), BF16)])
def test_vector_transformer_tower_matches_flax(rng, dtypes, tol):
    jc, pc = _tower_cfg()
    x = rng.normal(size=(6, 24)).astype(np.float32)
    jt = JaxVectorTower(cfg=jc, dtype=dtypes[0])
    params = jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = rng_params(params, np.random.default_rng(4))
    want = jax.jit(jt.apply)({"params": params}, jnp.asarray(x))
    pt = VectorTransformerTower(pc, dtype=dtypes[1])
    pt.load_state_dict(flax_to_state_dict(params), strict=True)
    assert pt.pos_embed.shape == (1, 8, 64)
    with torch.no_grad():
        got = pt(torch.from_numpy(x))
    assert got.shape == (6, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **tol)


def test_two_tower_with_transformer_towers_matches_flax():
    over = ["tower_a.input_dim=24", "tower_a.hidden_size=64", "tower_a.num_hidden_layers=2",
            "tower_a.architecture=transformer", "tower_a.dropout=0.0",
            "tower_b.input_dim=40", "tower_b.hidden_size=64", "tower_b.num_hidden_layers=1",
            "tower_b.architecture=transformer", "tower_b.dropout=0.0", "projection.dim=64",
            "projection.hidden_dim=128", "projection.dropout=0.0"]
    jcfg = jconfig.apply_overrides(jconfig.Config(), over)
    pcfg = pconfig.apply_overrides(pconfig.Config(), over)
    rng = np.random.default_rng(5)
    batch = {"a": rng.normal(size=(8, 24)).astype(np.float32),
             "b": rng.normal(size=(8, 40)).astype(np.float32)}
    jm = JaxTwoTowerCLIP(cfg=jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), _jnp(batch), deterministic=True)["params"]
    params = rng_params(params, np.random.default_rng(6))
    want = jax.jit(jm.apply)({"params": params}, _jnp(batch))
    port = load_flax_params(TwoTowerCLIP(pcfg, dtype=torch.float32), params)
    with torch.no_grad():
        got = port(_torch(batch))
    for k in ("emb_a", "emb_b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **F32)


def test_three_train_steps_match_jax(monkeypatch):
    """Dropout 0 everywhere (the reference's encoders fix theirs at 0.1, so
    both sides set it to 0 here): every leaf's gradient of the first step
    before the optimizer at 1e-4 of the leaf's largest entry, then the loss
    of three steps from the same weights and batches at rtol 1e-4."""
    monkeypatch.setattr(jtf, "_Encoder", _NoDropoutEncoder)
    jcfg, pcfg, jm, params, port = _pair(jnp.float32, torch.float32, STEP)
    _no_block_dropout(port)
    batches = [_batch(seed=s) for s in range(3)]
    jloss = jtrainer._multiway_loss_fn(jcfg)
    want = flax_to_state_dict(jax.jit(jax.grad(lambda p, b: jloss(
        p, jm.apply, b, jax.random.PRNGKey(0), None, None)[0]))(params, _jnp(batches[0])))
    loss, (metrics, emb_b) = ptrainer.make_loss_fn(pcfg)(port, to_device(batches[0], "cpu"),
                                                         DropoutSeeds(0, 0))
    assert emb_b is None  # tf_clip gives nothing to the hard-negative cache
    assert set(metrics) == {f"{k}_{a}_{b}" for k in ("loss", "accuracy")
                            for a, b in (("cell", "pert"), ("cell", "protein"),
                                         ("pert", "protein"))}
    loss.backward()
    for k, p in port.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
    js = jax_create_train_state(jm, jcfg, _jnp(batches[0]))
    js = js.replace(params=params, opt_state=js.tx.init(params))
    jstep = jax.jit(jax_make_train_step(jcfg))
    pst = create_train_state(port, pcfg, init=False)
    pstep = make_train_step(pcfg)
    for b in batches:
        js, jmetrics = jstep(js, _jnp(b))
        pst, pm = pstep(pst, to_device(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    assert pst.step == 3


def test_multiway_losses_match_jax(rng):
    embs = {k: rng.normal(size=(12, 32)).astype(np.float32) for k in ("cell", "pert", "protein")}
    ls = np.float32(2.6592)
    want, wm = jinfonce.multiway_clip_loss(_jnp(embs), jnp.asarray(ls))
    temb, tls = _torch(embs), torch.tensor(ls)
    got, gm = infonce.multiway_clip_loss(temb, tls)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5, err_msg=k)
    fused, fm = fused_multiway_clip_loss(temb, tls)
    np.testing.assert_allclose(float(fused), float(want), rtol=1e-4)
    for k in ("loss_cell_pert", "loss_cell_protein", "loss_pert_protein"):
        np.testing.assert_allclose(float(fm[k]), float(wm[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(fm["logit_scale"]), np.exp(ls), rtol=1e-6)


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
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_convert_loads_jax_init_strict():
    jcfg, pcfg = _cfgs()
    params = jax.jit(jtf.TFContrastiveModel(cfg=jcfg).init)(
        jax.random.PRNGKey(1), _jnp(_batch()))["params"]
    assert set(params["cell_in"]) == {"layers_0", "layers_1", "layers_3"}
    port = TFContrastiveModel(pcfg)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    want = np.asarray(params["cell_in"]["layers_3"]["kernel"]).T
    np.testing.assert_array_equal(port.cell_in.layers_3.kernel.detach().numpy(), want)
    n_flax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_flax


def test_full_width_parameter_count():
    """The default widths: 50,679,812 parameters, as the flax init counts."""
    model = TFContrastiveModel(pconfig.apply_overrides(pconfig.Config(), ["experiment=tf_clip"]),
                               device="meta")
    assert sum(p.numel() for p in model.parameters()) == 50_679_812


def test_train_cli_one_epoch_tf_clip(capsys, tmp_path):
    hist = train_cli.main(["--device", "cpu", "--epochs", "1",
                           *sum((["-o", o] for o in SMALL), []), "-o", "train.batch_size=128",
                           "-o", f"logging.log_dir={tmp_path}"])
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])
    assert np.isfinite(hist["val_loss"][0])
    out = capsys.readouterr().out
    assert '"experiment": "tf_clip"' in out and '"done": true' in out


@pytest.mark.parametrize("S", [1, 10, 63])
def test_multihead_attention_below_64_keys_is_plain_on_every_device(S, monkeypatch):
    """Separate q, k, v below 64 keys take the plain formulation whatever
    the device, as the reference's TPU gates send them to XLA (the protein
    tower's S = 1 among them); a device other than the CPU is shown with
    meta tensors, which carry no data. From 64 keys on the short-S kernel's
    entry takes them."""
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(2, S, 32, generator=g) for _ in range(3))
    mask = torch.ones(2, S, dtype=torch.bool)
    got = multihead_attention(q, k, v, 4, mask=mask)
    heads = [t.reshape(2, S, 4, 8).transpose(1, 2) for t in (q, k, v)]
    want = attention_reference(*heads, mask=mask).transpose(1, 2).reshape(2, S, 32)
    torch.testing.assert_close(got, want)
    meta = [t.to("meta") for t in (q, k, v)]
    assert multihead_attention(*meta, 4, mask=mask.to("meta")).shape == (2, S, 32)
    from clip_dplm_tpu_torch.ops import short_attention as sa

    calls = []
    monkeypatch.setattr(sa, "fused_short_attention",
                        lambda q, *a, **k: calls.append(q.shape) or torch.zeros_like(q))
    x = torch.empty(2, 64, 32, device="meta")
    multihead_attention(x, x, x, 4)
    assert calls == [x.shape]
