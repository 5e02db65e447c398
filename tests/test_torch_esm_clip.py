"""The port's RNA<->protein CLIP with an ESM-2 tower (clip_dplm_tpu_torch:
config.py's `esm` section, models/esm.py's soft token path,
models/protein_clip.py, the esm_clip registry entry, the freezing of the
ESM tower, the train CLI) against the JAX package on the same numpy weights
and batches, at a small size (RNA tower 2 blocks, d=64, 4 heads, 32 tokens +
CLS; ESM tower 2 layers, d=64, 4 heads: Dh=16 as ESM-2 8M has it, 64
protein tokens). Tolerances: the soft path against the hard one at one-hot
inputs and against JAX's soft path, and the model's embeddings, f32 rtol
1e-4 / atol 1e-5; the embeddings in bf16 rtol 0.05 / atol 0.03; three
deterministic train steps' losses rtol 1e-4 and every leaf's first
gradient rtol 1e-4 / atol 1e-5 of the leaf's largest entry. JAX on the CPU
computes its attention exactly (XLA), so the port's packed attention is
pinned to its recompute mode, as tests/test_torch_token_towers.py does."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.experiments.registry import build_data as jax_build_data
from clip_dplm_tpu.models import esm as jax_esm
from clip_dplm_tpu.models.protein_clip import ESMProteinCLIP as JaxESMProteinCLIP
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train import trainer as jtrainer
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.experiments import bench
from clip_dplm_tpu_torch.experiments import train as train_cli
from clip_dplm_tpu_torch.experiments.registry import EXPERIMENTS, build_data, build_model
from clip_dplm_tpu_torch.models import esm
from clip_dplm_tpu_torch.models.protein_clip import ESMProteinCLIP
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.train import trainer as ptrainer
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params
from test_torch_esm import _tokens, rng_params

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.03)
SMALL = ["experiment=esm_clip",
         "rna_tower.input_dim=24", "rna_tower.d_model=64", "rna_tower.num_layers=2",
         "rna_tower.num_heads=4", "rna_tower.max_len=64",
         "esm.d_model=64", "esm.num_layers=2", "esm.num_heads=4",
         "projection.dim=128", "projection.hidden_dim=256", "train.batch_size=8",
         "esm.frozen=false"]
NO_DROPOUT = ("rna_tower.dropout=0.0", "projection.dropout=0.0")
STEP = NO_DROPOUT + ("train.optim.schedule=constant", "train.optim.learning_rate=1e-3")
S_RNA, S_PROT = 32, 64


@pytest.fixture(autouse=True)
def recompute_mode(monkeypatch):
    """The packed attention's backward recomputes the probabilities in f32."""
    monkeypatch.setattr(sa, "saves_probs", lambda *a: False)


def _cfgs(extra=()):
    extra = list(extra)
    return (jconfig.apply_overrides(jconfig.Config(), SMALL + extra),
            pconfig.apply_overrides(pconfig.Config(), SMALL + extra))


def _batch(n=8, seed=0):
    rng = np.random.default_rng(seed)
    toks, mask = _tokens(rng, n, S_PROT, with_mask_tokens=False)
    return {"rna_tokens": rng.normal(size=(n, S_RNA, 24)).astype(np.float32),
            "rna_mask": np.arange(S_RNA)[None, :] < rng.integers(S_RNA // 2, S_RNA + 1, n)[:, None],
            "protein_tokens": toks, "protein_mask": mask}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _pair(extra, dtype_j, dtype_p, seed=3):
    """(JAX config, port config, JAX model, params, port model) on the same
    random weights; cached, so a test that trains the port asks for its own
    `extra`."""
    jcfg, pcfg = _cfgs(extra)
    jm = JaxESMProteinCLIP(cfg=jcfg, dtype=dtype_j)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), _jnp(_batch()))["params"]
    params = rng_params(params, np.random.default_rng(seed))
    params = dict(params, logit_scale=jnp.float32(2.6592))
    port = load_flax_params(ESMProteinCLIP(pcfg, dtype=dtype_p), params)
    return jcfg, pcfg, jm, params, port


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_esm_config_defaults_match_reference():
    """Every field of the port's `esm` and `dplm` sections equals the JAX
    Config()'s; the reference's esm_clip preset is ESM-2 8M (320 wide, 6
    layers, 20 heads: Dh = 16) with 8 candidates."""
    got, want = pconfig.Config(), jconfig.Config()
    for section in ("esm", "dplm"):
        g, w = getattr(got, section), getattr(want, section)
        assert dataclasses.asdict(g) == {k: getattr(w, k) for k in dataclasses.asdict(g)}
    e = got.esm
    assert (e.name, e.d_model, e.num_layers, e.num_heads, e.vocab_size) == (
        "esm2_t6_8M", 320, 6, 20, 33)
    assert got.dplm.num_candidates == 8 and got.dplm.guidance == "rerank"


@pytest.mark.parametrize("item,field,value", [
    ("esm.frozen=false", "frozen", False), ("esm.lora_rank=4", "lora_rank", 4),
    ("esm.d_model=480", "d_model", 480), ("esm.token_dropout=off", "token_dropout", False),
    ("esm.layer_norm_eps=1e-6", "layer_norm_eps", 1e-6), ("esm.name=esm2_t12_35M", "name",
                                                          "esm2_t12_35M")])
def test_esm_overrides(item, field, value):
    cfg = pconfig.apply_overrides(pconfig.Config(), [item])
    assert getattr(cfg.esm, field) == value
    assert getattr(jconfig.apply_overrides(jconfig.Config(), [item]).esm, field) == value


def test_esm_clip_is_registered():
    assert "esm_clip" in EXPERIMENTS
    _, pcfg = _cfgs()
    assert isinstance(build_model(pcfg, dtype=torch.float32), ESMProteinCLIP)


def test_lora_rank_raises_naming_lora():
    """Since models/lora.py is ported, esm.lora_rank no longer raises: the
    ESM tower builds with `*_lora` adapters (the default targets q and v,
    in every block) beside its unchanged base tree; an unknown target still
    raises, naming the valid sites."""
    _, pcfg = _cfgs(["esm.lora_rank=4"])
    model = build_model(pcfg)
    names = [k for k, _ in model.named_parameters() if "_lora." in k]
    assert sorted(names) == sorted(f"esm_tower.layer_{i}.{s}_lora.{p}" for i in range(2)
                                   for s in ("q", "v") for p in "ab")
    _, bad = _cfgs(["esm.lora_rank=4", 'esm.lora_targets=["q","qkv"]'])
    with pytest.raises(ValueError, match="LoRA targets"):
        build_model(bad)


# ---------------------------------------------------------------------------
# the ESM tower's soft token path
# ---------------------------------------------------------------------------


def _soft_probs(rng, toks, V=33):
    """Softmax of random logits with every special position one-hot."""
    logits = 2.0 * rng.normal(size=toks.shape + (V,))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    special = np.isin(toks, (0, 1, 2))
    probs[special] = np.eye(V)[toks[special]]
    return probs.astype(np.float32)


def _tower_pair(rng, S):
    jcfg = jconfig.ESMConfig(d_model=64, num_layers=2, num_heads=4)
    jt = jax_esm.ESMTower(cfg=jcfg, dtype=jnp.float32)
    toks, mask = _tokens(rng, 3, S)
    params = rng_params(jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(toks[:, :8]),
                                        jnp.asarray(mask[:, :8]))["params"], rng)
    port = load_flax_params(esm.ESMTower(pconfig.ESMConfig(d_model=64, num_layers=2,
                                                           num_heads=4), torch.float32), params)
    return jt, params, port, toks, mask


@pytest.mark.parametrize("pooling", ["mean_residues", "tokens"])
@pytest.mark.parametrize("S", [10, 70])
def test_soft_path_equals_hard_path_at_one_hot(rng, S, pooling):
    """Inputs with <mask> tokens, so token dropout's rescaling runs."""
    _, _, port, toks, mask = _tower_pair(rng, S)
    t, m = torch.from_numpy(toks), torch.from_numpy(mask)
    with torch.no_grad():
        hard = port(t, m, pooling=pooling)
        soft = port(t, m, pooling=pooling,
                    token_probs=torch.nn.functional.one_hot(t.long(), 33).float())
    np.testing.assert_allclose(soft.numpy(), hard.numpy(), **F32)


@pytest.mark.parametrize("S", [10, 70])
def test_soft_path_matches_jax(rng, S):
    jt, params, port, toks, mask = _tower_pair(rng, S)
    probs = _soft_probs(rng, toks)
    want = jax.jit(lambda p, t, m, pr: jt.apply({"params": p}, t, m, pooling="mean_residues",
                                                token_probs=pr))(
        params, jnp.asarray(toks), jnp.asarray(mask), jnp.asarray(probs))
    with torch.no_grad():
        got = port(torch.from_numpy(toks), torch.from_numpy(mask), pooling="mean_residues",
                   token_probs=torch.from_numpy(probs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtypes,tol", [((jnp.float32, torch.float32), F32),
                                        ((jnp.bfloat16, torch.bfloat16), BF16)])
def test_esm_protein_clip_matches_flax(dtypes, tol):
    _, _, jm, params, port = _pair(NO_DROPOUT, *dtypes)
    batch = _batch()
    want = jax.jit(jm.apply)({"params": params}, _jnp(batch))
    with torch.no_grad():
        got = port(_torch(batch))
    for k in ("emb_a", "emb_b"):
        assert got[k].dtype == torch.float32 and got[k].shape == (8, 128)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k], np.float32), **tol)
    assert float(got["logit_scale"].detach()) == pytest.approx(float(want["logit_scale"]))


def test_encode_protein_is_the_protein_side():
    _, _, _, _, port = _pair(NO_DROPOUT, jnp.float32, torch.float32)
    batch = _torch(_batch())
    with torch.no_grad():
        want = port(batch)["emb_b"]
        got = port.encode_protein(batch["protein_tokens"], batch["protein_mask"])
    torch.testing.assert_close(got, want)


def test_convert_loads_jax_init_strict():
    jcfg, pcfg = _cfgs()
    params = jax.jit(JaxESMProteinCLIP(cfg=jcfg).init)(jax.random.PRNGKey(1),
                                                        _jnp(_batch()))["params"]
    sd = flax_to_state_dict(params)
    assert {k.split(".", 1)[0] for k in sd} == {"rna_tower", "esm_tower", "rna_proj",
                                                "protein_proj", "logit_scale"}
    port = ESMProteinCLIP(pcfg)
    port.load_state_dict(sd, strict=True)
    want = np.asarray(params["esm_tower"]["layer_1"]["ffn_in"]["kernel"]).T
    np.testing.assert_array_equal(port.esm_tower.layer_1.ffn_in.kernel.detach().numpy(), want)


def test_convert_unstacks_a_scanned_esm_tower():
    """The esm_tower scope in the reference's scan_layers layout
    (layers/block stacked on axis 0) loads and gives the same embeddings."""
    jcfg, pcfg = _cfgs(NO_DROPOUT)
    jcfg = dataclasses.replace(jcfg, esm=dataclasses.replace(jcfg.esm, scan_layers=True))
    jm = JaxESMProteinCLIP(cfg=jcfg, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), _jnp(_batch()))["params"]
    assert "layers" in params["esm_tower"]
    port = load_flax_params(ESMProteinCLIP(pcfg, dtype=torch.float32), params)
    want = jax.jit(jm.apply)({"params": params}, _jnp(_batch()))
    with torch.no_grad():
        got = port(_torch(_batch()))
    np.testing.assert_allclose(got["emb_b"].numpy(), np.asarray(want["emb_b"]), **F32)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def test_three_train_steps_match_jax():
    """The loss of three steps from the same weights and batches (the plain
    InfoNCE: contrastive.use_fused_kernel is false, as in
    configs/esm_clip.yaml), and every leaf's gradient of the first step
    before the optimizer, the ESM tower trained."""
    jcfg, pcfg, jm, params, port = _pair(STEP, jnp.float32, torch.float32)
    assert not pcfg.contrastive.use_fused_kernel
    batches = [_batch(seed=s) for s in range(3)]
    jloss = jtrainer._pair_loss_fn(jcfg)
    want = flax_to_state_dict(jax.jit(jax.grad(lambda p, b: jloss(
        p, jm.apply, b, jax.random.PRNGKey(0), None, None)[0]))(params, _jnp(batches[0])))
    loss, _ = ptrainer._pair_loss_fn(pcfg)(port, to_device(batches[0], "cpu"),
                                           DropoutSeeds(0, 0))
    loss.backward()
    for k, p in port.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30), err_msg=k)
    assert any(p.grad.abs().max() > 0 for k, p in port.named_parameters()
               if k.startswith("esm_tower."))
    # the reference's create_train_state, its model.init jitted (eager it takes ~20 s)
    jit_init = types.SimpleNamespace(init=jax.jit(jm.init, static_argnames="deterministic"),
                                     apply=jm.apply)
    js = jax_create_train_state(jit_init, jcfg, _jnp(batches[0]))
    js = js.replace(params=params, opt_state=js.tx.init(params))
    jstep = jax.jit(jax_make_train_step(jcfg))
    pst = create_train_state(port, pcfg, init=False)
    pstep = make_train_step(pcfg)
    for b in batches:
        js, jmetrics = jstep(js, _jnp(b))
        pst, pm = pstep(pst, to_device(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    assert pst.step == 3 and pst.opt_state.count == 3


def test_frozen_tower_does_not_move():
    """esm.frozen: the tower's output is detached (no gradient reaches it)
    and its subtree's update is zero, decay included; the rest trains."""
    _, pcfg = _cfgs(["esm.frozen=true", *STEP])
    model = build_model(pcfg, dtype=torch.float32)
    state = create_train_state(model, pcfg)
    assert state.tx.frozen == ("esm_tower",)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _ = ptrainer._pair_loss_fn(pcfg)(model, to_device(_batch(), "cpu"), DropoutSeeds(0, 0))
    loss.backward()
    assert all(p.grad is None for k, p in model.named_parameters() if k.startswith("esm_tower."))
    for p in model.parameters():
        p.grad = None
    step = make_train_step(pcfg)
    for s in range(2):
        state, _ = step(state, to_device(_batch(seed=s), "cpu"))
    after = model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v) == k.startswith("esm_tower."), k


def test_registry_data_matches_jax():
    jcfg, pcfg = _cfgs(["train.batch_size=64", "rna_tower.input_dim=120"])
    jtrain, jval = jax_build_data(jcfg)
    ptrain, pval = build_data(pcfg)
    for fj, fp in ((lambda: jtrain(seed=2), lambda: ptrain(seed=2)), (jval, pval)):
        got, want = list(fp()), list(fj())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
    first = next(iter(ptrain(seed=0)))
    assert first["rna_tokens"].shape == (64, S_RNA, 120)
    assert first["protein_tokens"].shape == (64, S_PROT)


def test_bench_batch_has_the_data_shapes():
    _, pcfg = _cfgs()
    b = bench.esm_clip_batch(pcfg, 16, np.random.default_rng(0))
    toks = b["protein_tokens"]
    assert toks.shape == (16, S_PROT) and b["rna_tokens"].shape == (16, S_RNA, 24)
    assert (toks[:, 0] == 0).all() and ((toks == 2).sum(1) == 1).all()
    lens = (toks == 2).argmax(1) - 1
    assert ((lens >= S_PROT // 2) & (lens < S_PROT - 2)).all()
    assert (b["protein_mask"] == (toks != 1)).all()
    assert bench.esm_clip_step_flops(pcfg, 16) > 0


def test_train_cli_one_epoch_esm_clip_with_retrieval(capsys, tmp_path):
    hist = train_cli.main(["--device", "cpu", "--epochs", "1", "--retrieval",
                           *sum((["-o", o] for o in SMALL), []), "-o", "train.batch_size=64",
                           "-o", f"logging.log_dir={tmp_path}"])
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])
    for when in ("retrieval_untrained", "retrieval"):
        m = hist[when]
        assert 0.0 <= m["R@1"] <= m["R@5"] <= m["R@10"] <= 1.0
        assert m["mean_rank"] >= 0.0
    out = capsys.readouterr().out
    assert '"experiment": "esm_clip"' in out and '"retrieval": "trained"' in out
