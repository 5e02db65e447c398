"""The port's pretrained bundles and HF converters
(clip_dplm_tpu_torch/utils/pretrained.py, models/esm.py's
convert_esm_torch_params / export_esm_torch_params) and the serve and
generate CLIs' bundle flags, against the JAX package, at a small size
(esm_clip: ESM tower 2 layers d=64, RNA tower 2 blocks; DPLM 2 layers d=64):

- port -> port, JAX `save_pretrained` -> port `load_pretrained` and port ->
  JAX `load_pretrained`, for esm_clip and dplm: the config field for field
  and the same outputs (f32 rtol 1e-4 / atol 1e-5);
- a JAX-written (block YAML) config: unported fields held to their
  defaults, precision.compute_dtype other than bfloat16 refused, PyYAML
  named where it is missing;
- JAX `export_esm_torch_params` -> port `convert_esm_torch_params` gives
  JAX's outputs; the port's export equals JAX's bit for bit; unmerged
  adapters are refused;
- `serve --bundle --dplm-bundle --scorer-bundle` and `generate
  --dplm-bundle --scorer-bundle --condition --candidates` / `--esm-init`
  from bundles on the CPU.

JAX on the CPU computes its attention exactly (XLA), so the port's packed
attention is pinned to its recompute mode."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.models import dplm as jax_dplm
from clip_dplm_tpu.models import esm as jax_esm
from clip_dplm_tpu.models.protein_clip import ESMProteinCLIP as JaxESMProteinCLIP
from clip_dplm_tpu.utils import pretrained as jpre
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.data.protein import RESIDUES
from clip_dplm_tpu_torch.experiments import generate as generate_cli
from clip_dplm_tpu_torch.experiments import serve
from clip_dplm_tpu_torch.experiments.registry import build_model
from clip_dplm_tpu_torch.models import esm
from clip_dplm_tpu_torch.models.dplm import DPLM
from clip_dplm_tpu_torch.models.layers import init_params
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.utils import pretrained
from clip_dplm_tpu_torch.utils.convert import load_flax_params
from test_torch_esm import _tokens, rng_params

F32 = dict(rtol=1e-4, atol=1e-5)
CLIP = ["experiment=esm_clip", "rna_tower.input_dim=24", "rna_tower.d_model=64",
        "rna_tower.num_layers=2", "rna_tower.num_heads=4", "rna_tower.max_len=64",
        "esm.d_model=64", "esm.num_layers=2", "esm.num_heads=4", "projection.dim=32",
        "projection.hidden_dim=64", "esm.frozen=false"]
DPLM_SMALL = ["experiment=dplm", "dplm.d_model=64", "dplm.num_layers=2", "dplm.num_heads=2"]


@pytest.fixture(autouse=True)
def recompute_mode(monkeypatch):
    monkeypatch.setattr(sa, "saves_probs", lambda *a: False)


def _clip_batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    toks, mask = _tokens(rng, n, 70, with_mask_tokens=False)
    return {"rna_tokens": rng.normal(size=(n, 20, 24)).astype(np.float32),
            "rna_mask": np.arange(20)[None, :] < rng.integers(10, 21, n)[:, None],
            "protein_tokens": toks, "protein_mask": mask}


def _dplm_batch(n=3, seed=0):
    toks, mask = _tokens(np.random.default_rng(seed), n, 70)
    return toks, mask


@functools.lru_cache(maxsize=None)
def _jax_models():
    """(config, model, numpy-drawn params) of JAX's esm_clip and DPLM."""
    out = {}
    ccfg = jconfig.apply_overrides(jconfig.Config(), CLIP)
    cm = JaxESMProteinCLIP(cfg=ccfg, dtype=jnp.float32)
    b = jax.tree_util.tree_map(jnp.asarray, _clip_batch())
    cp = rng_params(jax.jit(cm.init)(jax.random.PRNGKey(0), b)["params"],
                    np.random.default_rng(1))
    out["esm_clip"] = (ccfg, cm, dict(cp, logit_scale=jnp.float32(2.6592)))
    dcfg = jconfig.apply_overrides(jconfig.Config(), DPLM_SMALL)
    dm = jax_dplm.DPLM(cfg=dcfg.dplm, dtype=jnp.float32)
    dp = rng_params(jax.jit(dm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))[
        "params"], np.random.default_rng(2))
    out["dplm"] = (dcfg, dm, dp)
    return out


def _jax_out(kind, model, params):
    if kind == "esm_clip":
        return jax.jit(lambda p, b: model.apply({"params": p}, b)["emb_b"])(
            params, jax.tree_util.tree_map(jnp.asarray, _clip_batch()))
    toks, mask = _dplm_batch()
    return jax.jit(model.apply)({"params": params}, jnp.asarray(toks), jnp.asarray(mask))


def _port_out(kind, model):
    with torch.no_grad():
        if kind == "esm_clip":
            b = {k: torch.from_numpy(v) for k, v in _clip_batch().items()}
            return model(b)["emb_b"].numpy()
        toks, mask = _dplm_batch()
        return model(torch.from_numpy(toks), torch.from_numpy(mask)).numpy()


def _port_cfg(jcfg):
    return pconfig.apply_overrides(pconfig.Config(), CLIP if jcfg.experiment == "esm_clip"
                                   else DPLM_SMALL)


@pytest.mark.parametrize("kind", ["esm_clip", "dplm"])
def test_port_bundle_roundtrip(tmp_path, kind):
    """save_pretrained -> load_pretrained in the port: the same config, the
    registry's model, every weight bit for bit, a JSON config.yaml."""
    jcfg, _, params = _jax_models()[kind]
    cfg = _port_cfg(jcfg)
    model = load_flax_params(build_model(cfg, dtype=torch.float32), params)
    pretrained.save_pretrained(str(tmp_path), cfg, model)
    with open(tmp_path / "config.yaml") as f:
        assert json.load(f)["experiment"] == kind
    cfg2, model2, sd = pretrained.load_pretrained(str(tmp_path), dtype=torch.float32)
    assert cfg2 == cfg and type(model2) is type(model)
    assert all(torch.equal(model2.state_dict()[k], v) for k, v in model.state_dict().items())
    np.testing.assert_array_equal(_port_out(kind, model2), _port_out(kind, model))


@pytest.mark.parametrize("kind", ["esm_clip", "dplm"])
def test_jax_bundle_loads_in_port(tmp_path, kind):
    """A bundle JAX's save_pretrained wrote (block YAML, compressed npz)
    loads in the port with JAX's outputs."""
    jcfg, jm, params = _jax_models()[kind]
    jpre.save_pretrained(str(tmp_path), jcfg, params)
    cfg, model, _ = pretrained.load_pretrained(str(tmp_path), dtype=torch.float32)
    assert cfg == _port_cfg(jcfg)
    np.testing.assert_allclose(_port_out(kind, model), np.asarray(_jax_out(kind, jm, params)),
                               **F32)


@pytest.mark.parametrize("kind", ["esm_clip", "dplm"])
def test_port_bundle_loads_in_jax(tmp_path, kind):
    """A bundle the port wrote (JSON config, f32 npz) loads in JAX's
    load_pretrained with the port's outputs."""
    jcfg, _, params = _jax_models()[kind]
    model = load_flax_params(build_model(_port_cfg(jcfg), dtype=torch.float32), params)
    pretrained.save_pretrained(str(tmp_path), _port_cfg(jcfg), model)
    cfg2, jm2, params2 = jpre.load_pretrained(str(tmp_path))
    assert cfg2 == jcfg
    jm2 = type(jm2)(cfg=cfg2.dplm if kind == "dplm" else cfg2, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(_jax_out(kind, jm2, params2)),
                               _port_out(kind, model), **F32)


def test_bare_esm_and_lora_bundles(tmp_path):
    """An ESM-2 tower's params at the top load as that tower (the bundles
    of the embed, serve and generate CLIs); a LoRA tower's adapters ride in
    the same npz; esm_tower_of / dplm_of / scorer_of pick the modules."""
    cfg = pconfig.apply_overrides(pconfig.Config(), [
        "esm.d_model=64", "esm.num_layers=2", "esm.num_heads=4", "esm.lora_rank=2"])
    tower = esm.ESMTower(cfg.esm, dtype=torch.float32)
    init_params(tower, torch.Generator().manual_seed(0))
    pretrained.save_pretrained(str(tmp_path), cfg, tower)
    with np.load(tmp_path / "params.npz") as z:
        assert "layer_0::q_lora::a" in z.files and z["layer_0::q::kernel"].shape == (64, 64)
        np.testing.assert_array_equal(z["layer_0::q::kernel"],
                                      tower.layer_0.q.kernel.detach().numpy().T)
    _, model, _ = pretrained.load_pretrained(str(tmp_path), dtype=torch.float32)
    assert isinstance(model, esm.ESMTower) and pretrained.esm_tower_of(model) is model
    toks = torch.from_numpy(_tokens(np.random.default_rng(0), 2, 20)[0])
    with torch.no_grad():
        np.testing.assert_array_equal(pretrained.scorer_of(model)(toks, toks != 1).numpy(),
                                      tower(toks, pooling="mean_residues").numpy())
    with pytest.raises(ValueError, match="no DPLM"):
        pretrained.dplm_of(model)


def _jax_yaml(tmp_path, **sections):
    cfg = jconfig.apply_overrides(jconfig.Config(), DPLM_SMALL)
    cfg = cfg.__class__(**{**cfg.__dict__, **{k: v(getattr(cfg, k)) for k, v in
                                              sections.items()}})
    path = tmp_path / "config.yaml"
    jconfig.save_config(cfg, str(path))
    return str(path)


def test_jax_config_holds_unported_fields_to_defaults(tmp_path, monkeypatch):
    import dataclasses

    cfg = pretrained.read_config(_jax_yaml(tmp_path))
    assert cfg == pconfig.apply_overrides(pconfig.Config(), DPLM_SMALL)
    # the table of unported defaults is JAX's, field for field
    jd = jconfig.to_dict(jconfig.Config())

    def walk(table, ref, path=""):
        for k, v in table.items():
            assert k in ref, path + k
            if isinstance(v, dict):
                walk(v, ref[k], f"{path}{k}.")
            else:
                assert v == ref[k], path + k

    walk(pretrained._UNPORTED, jd)
    for section, field, value in (("flow", "sinkhorn_epsilon", 0.5),
                                  ("precision", "param_dtype", "bfloat16"),
                                  ("train", "preemption_poll_batches", 4)):
        path = _jax_yaml(tmp_path, **{section: lambda c: dataclasses.replace(
            c, **{field: value})})
        with pytest.raises(ValueError, match=f"{section}.{field}"):
            pretrained.read_config(path)
    path = _jax_yaml(tmp_path, precision=lambda c: dataclasses.replace(
        c, compute_dtype="float32"))
    with pytest.raises(ValueError, match="nothing of the JAX package reads it"):
        pretrained.read_config(path)
    # fields ported since: read as they are
    path = _jax_yaml(tmp_path, precision=lambda c: dataclasses.replace(c, remat=True),
                     train=lambda c: dataclasses.replace(c, steps_per_call=4))
    cfg = pretrained.read_config(path)
    assert cfg.precision.remat is True and cfg.train.steps_per_call == 4
    # the stacked layout is read either way
    path = _jax_yaml(tmp_path, dplm=lambda c: dataclasses.replace(c, scan_layers=True))
    assert pretrained.read_config(path).dplm.d_model == 64
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        pretrained.read_config(_jax_yaml(tmp_path))


# ---------------------------------------------------------------------------
# the HF ESM converters
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_esm():
    jcfg = jconfig.ESMConfig(name="t", d_model=64, num_layers=2, num_heads=4)
    tower = jax_esm.ESMTower(cfg=jcfg, dtype=jnp.float32)
    params = rng_params(jax.jit(tower.init)(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 8), jnp.int32))["params"],
                        np.random.default_rng(4))
    return jcfg, tower, params


def test_convert_esm_from_jax_export_gives_jax_outputs():
    jcfg, tower, params = _jax_esm()
    hf = jax_esm.export_esm_torch_params(params, jcfg)
    pcfg = pconfig.ESMConfig(name="t", d_model=64, num_layers=2, num_heads=4)
    port = esm.ESMTower(pcfg, dtype=torch.float32)
    port.load_state_dict(esm.convert_esm_torch_params(
        {k: torch.from_numpy(v) for k, v in hf.items()}, pcfg))
    toks, mask = _tokens(np.random.default_rng(5), 3, 70)
    want = jax.jit(lambda p: tower.apply({"params": p}, jnp.asarray(toks), jnp.asarray(mask),
                                         pooling="mean_residues"))(params)
    with torch.no_grad():
        got = port(torch.from_numpy(toks), torch.from_numpy(mask), pooling="mean_residues")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # and into a DPLM through the warm start, as JAX's init_dplm_from_esm
    dplm = DPLM(pconfig.DPLMConfig(d_model=64, num_layers=2, num_heads=4), torch.float32)
    from clip_dplm_tpu_torch.models.dplm import init_dplm_from_esm

    init_dplm_from_esm(port, dplm)
    assert torch.equal(dplm.layer_1.ffn_out.kernel, port.layer_1.ffn_out.kernel)


def test_export_esm_equals_jax_bit_for_bit():
    jcfg, _, params = _jax_esm()
    pcfg = pconfig.ESMConfig(name="t", d_model=64, num_layers=2, num_heads=4)
    port = load_flax_params(esm.ESMTower(pcfg, dtype=torch.float32), params)
    got, want = esm.export_esm_torch_params(port, pcfg), jax_esm.export_esm_torch_params(
        params, jcfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    back = esm.convert_esm_torch_params(got, pcfg)
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())


def test_export_refuses_unmerged_adapters():
    pcfg = pconfig.ESMConfig(name="t", d_model=64, num_layers=1, num_heads=4, lora_rank=2)
    tower = esm.ESMTower(pcfg, dtype=torch.float32)
    init_params(tower, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="merge_lora"):
        esm.export_esm_torch_params(tower, pcfg)
    from clip_dplm_tpu_torch.models.lora import merge_lora, spec_from

    merged = merge_lora(tower.state_dict(), spec_from(pcfg))
    assert len(esm.export_esm_torch_params(merged, pcfg)) == 3 + 16


# ---------------------------------------------------------------------------
# the serve and generate CLIs from bundles
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """An ESM-2 tower (d=64), a DPLM (d=64) and an esm_clip scorer
    (projection dim 32), each saved by the port, and a 32-wide condition."""
    root = tmp_path_factory.mktemp("bundles")
    cfg = pconfig.apply_overrides(pconfig.Config(), ["esm.d_model=64", "esm.num_layers=2",
                                                     "esm.num_heads=4"])
    models = {"esm": (cfg, esm.ESMTower(cfg.esm)),
              "dplm": (pconfig.apply_overrides(pconfig.Config(), DPLM_SMALL), None),
              "clip": (pconfig.apply_overrides(pconfig.Config(), CLIP), None)}
    for i, (name, (c, m)) in enumerate(models.items()):
        m = m if m is not None else build_model(c)
        init_params(m, torch.Generator().manual_seed(i))
        pretrained.save_pretrained(str(root / name), c, m)
    np.savez(root / "cond.npz", embedding=np.random.default_rng(0).normal(size=32).astype(
        np.float32))
    np.savez(root / "cond64.npz", embedding=np.random.default_rng(1).normal(size=64).astype(
        np.float32))
    return root


def test_serve_cli_from_bundles(bundles):
    args = serve.parse_args([
        "--device", "cpu", "--bundle", str(bundles / "esm"), "--dplm-bundle",
        str(bundles / "dplm"), "--scorer-bundle", str(bundles / "clip"), "--max-len", "64",
        "--max-batch", "2", "--gen-max-len", "6", "--gen-steps", "2", "--gen-max-batch", "2",
        "--gen-candidates", "3"])
    embed_svc, gen_svc = serve.build_services(args)
    try:
        _, tower, _ = pretrained.load_pretrained(str(bundles / "esm"))
        want = tower(*[torch.from_numpy(t) for t in _one("MKTAYIAK")], pooling="mean_residues")
        got = embed_svc.embed(["MKTAYIAK"])
        np.testing.assert_allclose(got[0], want[0].float().detach().numpy(), rtol=0.05,
                                   atol=0.03)
        assert gen_svc.num_candidates == 3
        seqs, scores = gen_svc.generate([5, 3], timeout=120, condition=np.ones(32, np.float32))
        assert [len(s) for s in seqs] == [5, 3] and all(-1.0 <= s <= 1.0 for s in scores)
    finally:
        embed_svc.close()
        gen_svc.close()
    with pytest.raises(SystemExit, match="--allow-random"):
        serve.build_services(serve.parse_args(["--device", "cpu"]))
    with pytest.raises(SystemExit, match="--dplm-bundle"):
        serve.build_services(serve.parse_args(["--device", "cpu", "--no-embed",
                                               "--scorer-bundle", str(bundles / "clip")]))


def _one(seq):
    from clip_dplm_tpu_torch.data.protein import tokenize_batch

    return tokenize_batch([seq], max_len=64)


def _jax_cli_scores(bundle, seqs, condition):
    """The scores JAX's generate CLI gives these sequences: the cosine of the
    scorer bundle's bare ESM tower's mean-residue embedding (bf16) with the
    condition (clip_dplm_tpu/experiments/generate.py)."""
    from clip_dplm_tpu_torch.data.protein import tokenize_batch

    scfg, _, sparams = jpre.load_pretrained(str(bundle))
    tower = jax_esm.ESMTower(cfg=scfg.esm, dtype=jnp.bfloat16)
    toks, mask = tokenize_batch(seqs, pad_multiple=1)
    emb = np.asarray(tower.apply({"params": sparams.get("esm_tower", sparams)},
                                 jnp.asarray(toks), jnp.asarray(mask),
                                 pooling="mean_residues"), np.float32)
    emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    return emb @ (condition / np.linalg.norm(condition))


def test_generate_cli_from_bundles(bundles, tmp_path, capsys):
    """Guided generation scores as JAX's CLI does, with the scorer bundle's
    bare ESM tower: the condition has the tower's width (64), and one of the
    projection's width (32, what `serve --scorer-bundle` takes) is refused."""
    out = str(tmp_path / "guided.fasta")
    generate_cli.main(["--device", "cpu", "--output", out, "--dplm-bundle",
                       str(bundles / "dplm"), "--scorer-bundle", str(bundles / "clip"),
                       "--condition", str(bundles / "cond64.npz"), "--candidates", "3",
                       "--length", "7", "--num", "2", "--steps", "2"])
    lines = open(out).read().splitlines()
    assert len(lines) == 4 and all(len(s) == 7 and set(s) <= set(RESIDUES)
                                   for s in lines[1::2])
    scores = np.array([float(x.split("score=")[1]) for x in lines[::2]])
    want = _jax_cli_scores(bundles / "clip", lines[1::2],
                           np.load(bundles / "cond64.npz")["embedding"])
    np.testing.assert_allclose(scores, want, rtol=0.05, atol=0.03)
    assert "RANDOM" not in capsys.readouterr().out
    with pytest.raises(RuntimeError):
        generate_cli.main(["--device", "cpu", "--output", out, "--dplm-bundle",
                           str(bundles / "dplm"), "--scorer-bundle", str(bundles / "clip"),
                           "--condition", str(bundles / "cond.npz"), "--candidates", "2",
                           "--length", "5", "--num", "1", "--steps", "1"])
    # --esm-init warm-starts the random DPLM 640/12/10 from a 640-wide tower
    cfg = pconfig.apply_overrides(pconfig.Config(), ["esm.d_model=640", "esm.num_layers=1",
                                                     "esm.num_heads=10"])
    tower = esm.ESMTower(cfg.esm)
    init_params(tower, torch.Generator().manual_seed(7))
    pretrained.save_pretrained(str(tmp_path / "esm640"), cfg, tower)
    out = str(tmp_path / "warm.fasta")
    generate_cli.main(["--device", "cpu", "--output", out, "--esm-init",
                       str(tmp_path / "esm640"), "--length", "5", "--num", "1", "--steps", "1"])
    assert "warm-started trunk" in capsys.readouterr().out and os.path.exists(out)
    with pytest.raises(ValueError, match="ESM"):  # a 64-wide tower does not fit 640
        generate_cli.main(["--device", "cpu", "--output", out, "--esm-init",
                           str(bundles / "esm"), "--length", "5", "--num", "1"])
