"""The port's flagship RNA<->RBP token transformer (clip_dplm_tpu_torch:
models/layers.py::TransformerBlock, models/token_towers.py, data/collate.py,
the rna_rbp registry entry and the train CLI) against the JAX package on the
same numpy weights and batches, at a small size (2 blocks, d=64, 4 heads,
64 tokens + CLS): the block with and without `out_rows=1` (f32, rtol 1e-4),
its exact dead-code elimination (values and gradients at the JAX suite's
1e-6 / 1e-5), the tower under cls and mean pooling, RNARBPCLIP in f32 (rtol
1e-4) and bf16 (rtol 0.05 / atol 0.03), three deterministic train steps
(loss rtol 1e-4) and the first step's gradient of every leaf, the rna_rbp
train CLI for one epoch on the CPU, and the token-pair batches of one
seed. JAX on the CPU computes its attention exactly (XLA, no kernel), so
the port's packed attention is pinned to its recompute mode here, as the
JAX suite pins its own (tests/test_esm.py); the saved mode has
tests/test_torch_saved_probs.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.data.collate import TokenPairDataset as JaxTokenPairDataset
from clip_dplm_tpu.models.layers import TransformerBlock as JaxBlock
from clip_dplm_tpu.models.token_towers import RNARBPCLIP as JaxRNARBPCLIP
from clip_dplm_tpu.models.token_towers import TokenTransformerTower as JaxTower
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train import trainer as jtrainer
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.data.collate import TokenPairDataset
from clip_dplm_tpu_torch.experiments import train as train_cli
from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
from clip_dplm_tpu_torch.models.layers import TransformerBlock
from clip_dplm_tpu_torch.models.token_towers import RNARBPCLIP, TokenTransformerTower
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.train import trainer as ptrainer
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params
from test_torch_esm import rng_params

SMALL = ["experiment=rna_rbp",
         "rna_tower.input_dim=24", "rna_tower.d_model=64", "rna_tower.num_layers=2",
         "rna_tower.num_heads=4", "rna_tower.max_len=64",
         "rbp_tower.input_dim=48", "rbp_tower.d_model=64", "rbp_tower.num_layers=2",
         "rbp_tower.num_heads=4", "rbp_tower.max_len=128",
         "projection.dim=128", "projection.hidden_dim=256", "train.batch_size=8"]
NO_DROPOUT = ["rna_tower.dropout=0.0", "rbp_tower.dropout=0.0", "projection.dropout=0.0"]
STEP = NO_DROPOUT + ["train.optim.schedule=constant", "train.optim.learning_rate=1e-3"]
TOKENS = 64  # + CLS = 65: the packed short-S path in the first block


@pytest.fixture(autouse=True)
def recompute_mode(monkeypatch):
    """The packed attention's backward recomputes the probabilities in f32."""
    monkeypatch.setattr(sa, "saves_probs", lambda *a: False)


def _cfgs(extra):
    return (jconfig.apply_overrides(jconfig.Config(), SMALL + extra),
            pconfig.apply_overrides(pconfig.Config(), SMALL + extra))


def _batch(n=8, seed=0, tokens=TOKENS):
    rng = np.random.default_rng(seed)
    la, lb = rng.integers(tokens // 3, tokens + 1, n), rng.integers(tokens // 3, tokens + 1, n)
    return {"rna_tokens": rng.normal(size=(n, tokens, 24)).astype(np.float32),
            "rna_mask": np.arange(tokens)[None, :] < la[:, None],
            "rbp_tokens": rng.normal(size=(n, tokens, 48)).astype(np.float32),
            "rbp_mask": np.arange(tokens)[None, :] < lb[:, None]}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _random_params(module, args, seed):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *args)["params"]
    return rng_params(params, np.random.default_rng(seed))


def _block_inputs(rng, B=2, S=65, d=32):
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    mask = np.arange(S)[None, :] < np.array([[S], [S // 2]])[:B]
    ct = rng.normal(size=(B, S, d)).astype(np.float32)
    return x, mask, ct


@pytest.mark.parametrize("S,out_rows", [(65, None), (65, 1), (10, None)])
def test_block_matches_flax(rng, S, out_rows):
    """S=65: the full block takes the packed short-S path (plain version on
    the CPU), out_rows=1 the CLS-query path; S=10 the packed tiny-S path.
    JAX on the CPU takes its XLA formulations. Values and every gradient,
    f32."""
    x, mask, ct = _block_inputs(rng, S=S)
    rows = x.shape[1] if out_rows is None else out_rows
    ct = ct[:, :rows]
    jb = JaxBlock(d_model=32, num_heads=2, dropout=0.0, dtype=jnp.float32, out_rows=out_rows)
    params = _random_params(jb, (jnp.asarray(x), jnp.asarray(mask)), 1)

    def jloss(p, xx):
        return jnp.sum(jb.apply({"params": p}, xx, jnp.asarray(mask)) * ct)

    want = jax.jit(jb.apply)({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    pb = TransformerBlock(32, 2, dropout=0.0, dtype=torch.float32, out_rows=out_rows)
    pb.load_state_dict(flax_to_state_dict(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pb(xt, torch.from_numpy(mask))
    torch.sum(got * torch.from_numpy(ct)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    want_g = flax_to_state_dict(gp)
    for k, p in pb.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_block_out_rows_is_exact_dce(rng):
    """out_rows=1 (the CLS-query path) equals the full block (the packed
    path) then [:, :1], values and gradients, at the JAX suite's bounds."""
    x, mask, ct = _block_inputs(rng)
    ct = torch.from_numpy(ct[:, :1])
    full = TransformerBlock(32, 2, dropout=0.0, dtype=torch.float32)
    cut = TransformerBlock(32, 2, dropout=0.0, dtype=torch.float32, out_rows=1)
    gen = torch.Generator().manual_seed(0)
    for m in full.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    cut.load_state_dict(full.state_dict())
    outs, grads = [], []
    for block, take in ((full, lambda y: y[:, :1]), (cut, lambda y: y)):
        y = take(block(torch.from_numpy(x), torch.from_numpy(mask)))
        y.backward(ct)
        outs.append(y.detach())
        grads.append({k: p.grad for k, p in block.named_parameters()})
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-6, atol=1e-6)
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_tower_matches_flax(rng, pooling):
    jcfg, pcfg = _cfgs([f"rna_tower.pooling={pooling}"])
    b = _batch()
    x, mask = b["rna_tokens"], b["rna_mask"]
    jt = JaxTower(cfg=jcfg.rna_tower, dtype=jnp.float32)
    params = _random_params(jt, (jnp.asarray(x), jnp.asarray(mask)), 2)
    want = jax.jit(jt.apply)({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    pt = TokenTransformerTower(pcfg.rna_tower, dtype=torch.float32)
    pt.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = pt(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (8, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _pair(extra, dtype_j, dtype_p, seed=3):
    jcfg, pcfg = _cfgs(extra)
    jm = JaxRNARBPCLIP(cfg=jcfg, dtype=dtype_j)
    params = _random_params(jm, (_jnp(_batch()),), seed)
    params = dict(params, logit_scale=jnp.float32(2.6592))
    port = load_flax_params(RNARBPCLIP(pcfg, dtype=dtype_p), params)
    return jcfg, pcfg, jm, params, port


@pytest.mark.parametrize("dtypes,tol", [((jnp.float32, torch.float32), dict(rtol=1e-4, atol=1e-5)),
                                        ((jnp.bfloat16, torch.bfloat16),
                                         dict(rtol=0.05, atol=0.03))])
def test_rna_rbp_clip_matches_flax(dtypes, tol):
    _, _, jm, params, port = _pair(NO_DROPOUT, *dtypes)
    batch = _batch()
    want = jax.jit(jm.apply)({"params": params}, _jnp(batch))
    with torch.no_grad():
        got = port(_torch(batch))
    for k in ("emb_a", "emb_b"):
        assert got[k].dtype == torch.float32 and got[k].shape == (8, 128)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k], np.float32), **tol)
    assert float(got["logit_scale"].detach()) == pytest.approx(float(want["logit_scale"]))


def test_three_train_steps_match_jax():
    """The loss of three steps from the same weights and batches, and every
    leaf's gradient of the first step before the optimizer (f32, 1e-4 of the
    leaf's largest entry). Parameters after the steps are not compared:
    Adam's first updates are about -lr·sign(g), so a leaf whose gradient is
    rounding noise (the k part of the qkv bias has none: softmax is shift
    invariant) moves by +-lr on either side. The fused heads and loss are
    held to JAX in test_torch_two_tower.py."""
    jcfg, pcfg, jm, params, port = _pair(STEP, jnp.float32, torch.float32)
    batches = [_batch(seed=s) for s in range(3)]
    jloss = jtrainer._pair_loss_fn(jcfg)
    want = flax_to_state_dict(jax.jit(jax.grad(lambda p, b: jloss(
        p, jm.apply, b, jax.random.PRNGKey(0), None, None)[0]))(params, _jnp(batches[0])))
    loss, _ = ptrainer._pair_loss_fn(pcfg)(port, to_device(batches[0], "cpu"),
                                           DropoutSeeds(0, 0))
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
    assert pst.step == 3 and pst.opt_state.count == 3


def test_dropout_masks_follow_the_seeds():
    """With dropout on, a forward is a function of (key, step): the same
    seeds give the same embeddings, another step other ones."""
    _, pcfg = _cfgs([])
    model = build_model(pcfg, dtype=torch.float32)
    create_train_state(model, pcfg)
    batch = _torch(_batch())
    runs = [model(batch, deterministic=False, seeds=DropoutSeeds(7, s))["emb_a"]
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_convert_loads_jax_init_strict():
    jcfg, pcfg = _cfgs([])
    params = jax.jit(JaxRNARBPCLIP(cfg=jcfg).init)(jax.random.PRNGKey(1), _jnp(_batch()))
    params = params["params"]
    port = RNARBPCLIP(pcfg)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    assert port.rna_tower.pos_embed.shape == (1, 64, 64)
    assert port.rbp_tower.cls_token.shape == (1, 1, 64)
    want = np.asarray(params["rna_tower"]["block_0"]["out_proj"]["kernel"]).T
    np.testing.assert_array_equal(port.rna_tower.block_0.out_proj.kernel.detach().numpy(), want)


def test_token_pair_batches_match_jax():
    a = JaxTokenPairDataset.synthetic(40, dim_a=24, dim_b=48, seed=5)
    b = TokenPairDataset.synthetic(40, dim_a=24, dim_b=48, seed=5)
    for ja, pa in zip(a.batches(16, seed=3, pad_to_a=64, pad_to_b=128),
                      b.batches(16, seed=3, pad_to_a=64, pad_to_b=128)):
        assert ja.keys() == pa.keys()
        for k in ja:
            assert ja[k].dtype == pa[k].dtype
            np.testing.assert_array_equal(ja[k], pa[k])


def test_registry_data_matches_jax():
    from clip_dplm_tpu.experiments.registry import build_data as jax_build_data

    jcfg, pcfg = _cfgs(["train.batch_size=64"])
    jtrain, jval = jax_build_data(jcfg)
    ptrain, pval = build_data(pcfg)
    for fj, fp in ((lambda: jtrain(seed=2), lambda: ptrain(seed=2)), (jval, pval)):
        got, want = list(fp()), list(fj())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_train_cli_defaults_to_the_card(monkeypatch, tmp_path):
    assert train_cli.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_cli.main(["--epochs", "1", "-o", "experiment=rna_rbp",
                        "-o", f"logging.log_dir={tmp_path}"])


def test_train_cli_one_epoch_rna_rbp(capsys, tmp_path):
    hist = train_cli.main(["--device", "cpu", "--epochs", "1",
                           *sum((["-o", o] for o in SMALL), []), "-o", "train.batch_size=128",
                           "-o", f"logging.log_dir={tmp_path}"])
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])
    assert np.isfinite(hist["val_loss"][0])
    out = capsys.readouterr().out
    assert '"experiment": "rna_rbp"' in out and '"done": true' in out
