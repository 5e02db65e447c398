"""CLIP-guided generation in the port (clip_dplm_tpu_torch: models/dplm.py's
`logit_bias_fn` and `clip_guided_sample`, models/guided_generation.py, the
guided lane of serving.py, experiments/serve.py's guided flags and
experiments/generate.py) against the JAX package on the same tokens, logits
and weights, on the CPU, at a small size (the protein side of a small
ESMProteinCLIP: ESM tower 2 layers, d=64, 4 heads; DPLM 64/2/2).
Tolerances: scores f32 rtol 1e-5 / atol 1e-6; the soft guidance bias f32
rtol 1e-4 / atol 1e-5 of its largest entry. The sampler's random draws
cannot match JAX's PRNG: the best-of-K pick is compared on fixed
candidates, and the bias's place in the sampler through the one-step
greedy draw (temperature 0), which no draw moves."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.models import dplm as jax_dplm
from clip_dplm_tpu.models import guided_generation as jax_guided
from clip_dplm_tpu.models.esm import ESMTower as JaxESMTower
from clip_dplm_tpu.models.layers import OptimizedProjectionHead as JaxHead
from clip_dplm_tpu.models.protein_clip import ESMProteinCLIP as JaxESMProteinCLIP
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.config import DPLMConfig
from clip_dplm_tpu_torch.experiments import generate as generate_cli
from clip_dplm_tpu_torch.experiments import serve
from clip_dplm_tpu_torch.models import dplm, guided_generation
from clip_dplm_tpu_torch.models.layers import init_params
from clip_dplm_tpu_torch.models.protein_clip import ESMProteinCLIP
from clip_dplm_tpu_torch.serving import GenerateService, make_server
from clip_dplm_tpu_torch.utils.convert import load_flax_params
from test_torch_esm import _tokens, rng_params

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = ["experiment=esm_clip", "rna_tower.input_dim=24", "rna_tower.d_model=64",
         "rna_tower.num_layers=1", "rna_tower.num_heads=4", "esm.d_model=64",
         "esm.num_layers=2", "esm.num_heads=4", "projection.dim=32",
         "projection.hidden_dim=64", "rna_tower.dropout=0.0", "projection.dropout=0.0"]
RESIDUES = set("LAGVSERTIDPKQNFYMHWC")
K, B, S = 3, 4, 20


@pytest.fixture(scope="module")
def clip_pair():
    """(JAX protein encoder, JAX soft encoder, port ESMProteinCLIP) on the
    same random weights, f32."""
    jcfg = jconfig.apply_overrides(jconfig.Config(), SMALL)
    pcfg = pconfig.apply_overrides(pconfig.Config(), SMALL)
    rng = np.random.default_rng(7)
    toks, mask = _tokens(rng, 2, 16)
    batch = {"rna_tokens": jnp.zeros((2, 8, 24)), "rna_mask": jnp.ones((2, 8), bool),
             "protein_tokens": jnp.asarray(toks), "protein_mask": jnp.asarray(mask)}
    params = jax.jit(JaxESMProteinCLIP(cfg=jcfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), batch)["params"]
    params = rng_params(params, rng)
    tower = JaxESMTower(cfg=jcfg.esm, dtype=jnp.float32)
    head = JaxHead(cfg=jcfg.projection, dtype=jnp.float32)

    def encode(t, m, probs=None):
        emb = tower.apply({"params": params["esm_tower"]}, t, m, pooling="mean_residues",
                          token_probs=probs)
        return head.apply({"params": params["protein_proj"]}, emb)

    port = load_flax_params(ESMProteinCLIP(pcfg, dtype=torch.float32),
                            dict(params, logit_scale=jnp.float32(2.6592)))
    return jax.jit(encode), jax.jit(lambda p, t: encode(t, t != 1, p)), port.eval()


def _candidates(rng, n):
    toks, _ = _tokens(rng, n, S, with_mask_tokens=False)
    return toks


def _port_encode(port):
    return lambda t, m: port.encode_protein(t, m)


def _conditions(rng, d=32):
    return {"one": rng.normal(size=(d,)).astype(np.float32),
            "rows": rng.normal(size=(B, d)).astype(np.float32)}


# ---------------------------------------------------------------------------
# scorers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["one", "rows"])
def test_clip_scorer_matches_jax(clip_pair, which):
    """Per candidate and row: K candidates of B rows in one call (the JAX
    scorer vmapped over K)."""
    encode, _, port = clip_pair
    rng = np.random.default_rng(1)
    cands = _candidates(rng, K * B).reshape(K, B, S)
    cond = _conditions(rng)[which]
    want = jax.vmap(jax_guided.make_clip_scorer(encode, jnp.asarray(cond)))(jnp.asarray(cands))
    with torch.no_grad():
        got = guided_generation.make_clip_scorer(_port_encode(port), cond)(
            torch.from_numpy(cands))
    assert got.shape == (K, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    with torch.no_grad():  # a (B, S) call keeps the reference's contract
        one = guided_generation.make_clip_scorer(_port_encode(port), cond)(
            torch.from_numpy(cands[1]))
    np.testing.assert_allclose(one.numpy(), np.asarray(want)[1], **SCORE_TOL)


def _sampler_state(rng, rows=B):
    """Half-decided rows: tokens with <mask> at undecided residue positions
    and the sampler's logits (residue-only bias at -1e30)."""
    toks, _ = _tokens(rng, rows, S, with_mask_tokens=False)
    undecided = (toks >= 4) & (rng.random(toks.shape) < 0.5)
    toks = np.where(undecided, 32, toks).astype(np.int32)
    logits = rng.normal(size=(rows, S, 33)).astype(np.float32)
    logits[..., :4] = -1e30
    logits[..., 24:] = -1e30
    return toks, logits


@pytest.mark.parametrize("which,scale", [("one", 1.0), ("rows", 2.5)])
def test_soft_logit_bias_matches_jax(clip_pair, which, scale):
    encode, soft_encode, port = clip_pair
    rng = np.random.default_rng(2)
    toks, logits = _sampler_state(rng)
    cond = _conditions(rng)[which]
    want = jax_guided.make_soft_logit_bias_fn(
        jax_guided.make_soft_clip_scorer(soft_encode, jnp.asarray(cond)), scale)(
            jnp.asarray(toks), jnp.asarray(logits))
    want = np.asarray(want)
    soft = guided_generation.make_soft_clip_scorer(
        lambda p, t: port.encode_protein(t, t != 1, token_probs=p), cond)
    with torch.no_grad():  # as inside the sampler
        got = guided_generation.make_soft_logit_bias_fn(soft, scale)(
            torch.from_numpy(toks), torch.from_numpy(logits))
    assert got.shape == (B, S, 33) and got.dtype == torch.float32
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    decided = toks != 32
    assert (got.numpy()[decided] == 0).all()  # one-hot positions carry no gradient


def test_soft_bias_ascends_the_relaxed_score(clip_pair):
    """A small step along the bias raises the relaxed score of every row."""
    _, _, port = clip_pair
    rng = np.random.default_rng(3)
    toks, logits = _sampler_state(rng)
    toks, logits = torch.from_numpy(toks), torch.from_numpy(logits)
    soft = guided_generation.make_soft_clip_scorer(
        lambda p, t: port.encode_protein(t, t != 1, token_probs=p),
        _conditions(rng)["rows"])
    bias = guided_generation.make_soft_logit_bias_fn(soft, 1.0)(toks, logits)

    def relaxed(lg):
        onehot = torch.nn.functional.one_hot(toks.long(), 33).float()
        x = torch.where((toks == 32)[..., None], torch.softmax(lg, -1), onehot)
        with torch.no_grad():
            return soft(x, toks)

    step = 1e-2 / bias.abs().max()
    assert (relaxed(logits + step * bias) > relaxed(logits)).all()


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def _dplm_pair(rng, steps=4):
    kw = dict(d_model=64, num_layers=2, num_heads=2, max_len=64, num_diffusion_steps=steps)
    model = jax_dplm.DPLM(cfg=jconfig.DPLMConfig(**kw), dtype=jnp.float32)
    params = rng_params(jax.jit(model.init)(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 8), jnp.int32))["params"], rng)
    port = load_flax_params(dplm.DPLM(DPLMConfig(**kw), dtype=torch.float32), params)
    return model, params, port


def test_one_step_greedy_sample_with_bias_matches_jax(rng):
    """temperature 0, one step: the proposal is the argmax of logits + bias,
    so the bias's place in the step shows token for token."""
    model, params, port = _dplm_pair(rng)
    bias = (3.0 * rng.normal(size=(33,))).astype(np.float32)
    lengths = np.array([12, 5, 9], np.int32)
    want_t, _ = jax_dplm.sample(
        model, params, jax.random.PRNGKey(1), batch_size=3, length=12, num_steps=1,
        temperature=0.0, logit_bias_fn=lambda t, lg: jnp.asarray(bias)[None, None],
        lengths=jnp.asarray(lengths))
    got_t, _ = dplm.sample(
        port, torch.Generator().manual_seed(1), batch_size=3, length=12, num_steps=1,
        temperature=0.0, logit_bias_fn=lambda t, lg: torch.from_numpy(bias)[None, None],
        lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    plain, _ = dplm.sample(port, torch.Generator().manual_seed(1), batch_size=3, length=12,
                           num_steps=1, temperature=0.0, lengths=torch.from_numpy(lengths))
    assert not torch.equal(plain, got_t)


@pytest.mark.parametrize("flatten", [True, False])
def test_large_bias_drives_the_chain(rng, flatten):
    """A +1e4 bias on one residue makes every generated residue that one,
    in both chain forms; the bias sees the (K, B, ...) views when flattened
    and (B, ...) per chain."""
    _, _, port = _dplm_pair(rng)
    target = 9  # 'I'
    shapes = []

    def bias_fn(tokens, logits):
        shapes.append((tuple(tokens.shape), tuple(logits.shape)))
        b = torch.zeros(33)
        b[target] = 1e4
        return b

    toks, scores = dplm.clip_guided_sample(
        port, torch.Generator().manual_seed(2), lambda c: c.float().mean(-1), batch_size=B,
        length=10, num_candidates=K, num_steps=3, logit_bias_fn=bias_fn,
        lengths=torch.tensor([10, 4, 7, 1]), flatten_chains=flatten)
    assert toks.shape == (B, 12) and scores.shape == (B,)
    for i, L in enumerate([10, 4, 7, 1]):
        assert (toks[i, 1:L + 1] == target).all()
        assert toks[i, L + 1] == dplm.EOS_IDX
    want = ((K, B, 12), (K, B, 12, 33)) if flatten else ((B, 12), (B, 12, 33))
    assert set(shapes) == {want}


@pytest.mark.parametrize("which", ["one", "rows"])
def test_clip_guided_sample_pick_matches_jax(clip_pair, monkeypatch, which):
    """On fixed candidates (the sampler patched to return them), the pick
    and its score equal JAX's flattened best-of-K, in both of the port's
    chain forms."""
    encode, _, port = clip_pair
    rng = np.random.default_rng(4)
    cands = _candidates(rng, K * B)
    cond = _conditions(rng)[which]
    jdplm = jax_dplm.DPLM(cfg=jconfig.DPLMConfig(d_model=64, num_layers=1, num_heads=2))
    monkeypatch.setattr(jax_dplm, "sample", lambda *a, **k: (jnp.asarray(cands), None))
    want_t, want_s = jax_dplm.clip_guided_sample(
        jdplm, None, jax.random.PRNGKey(0), jax_guided.make_clip_scorer(encode, jnp.asarray(cond)),
        batch_size=B, length=S - 2, num_candidates=K)
    chains = iter(cands.reshape(K, B, S))
    pdplm = dplm.DPLM(DPLMConfig(d_model=64, num_layers=1, num_heads=2), dtype=torch.float32)
    for flatten in (True, False):
        monkeypatch.setattr(dplm, "sample", lambda *a, **k: (
            torch.from_numpy(cands if flatten else next(chains)), None))
        got_t, got_s = dplm.clip_guided_sample(
            pdplm, torch.Generator(), guided_generation.make_clip_scorer(_port_encode(port), cond),
            batch_size=B, length=S - 2, num_candidates=K, flatten_chains=flatten)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **SCORE_TOL)


def test_generate_for_condition_with_soft_guidance(clip_pair):
    """Reranking and soft guidance composed: rows of residues, each score
    the cosine of the returned row with the condition."""
    _, _, port = clip_pair
    _, _, model = _dplm_pair(np.random.default_rng(5), steps=3)
    cond = _conditions(np.random.default_rng(6))["one"]
    calls = []

    def soft_encode(p, t):
        calls.append(tuple(p.shape))
        return port.encode_protein(t, t != 1, token_probs=p)

    toks, scores = guided_generation.generate_proteins_for_condition(
        model, _port_encode(port), cond, torch.Generator().manual_seed(0), length=8,
        batch_size=2, num_candidates=3, soft_encode_fn=soft_encode, guidance_scale=5.0)
    assert toks.shape == (2, 10) and calls == [(6, 10, 33)] * 3
    assert ((toks[:, 1:9] >= 4) & (toks[:, 1:9] <= 23)).all()
    with torch.no_grad():
        again = guided_generation.make_clip_scorer(_port_encode(port), cond)(toks)
    torch.testing.assert_close(again, scores)


# ---------------------------------------------------------------------------
# the guided lane of the server and the CLIs
# ---------------------------------------------------------------------------


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read().decode())


def test_guided_server_routes_and_400s(clip_pair):
    """condition and condition_id answer with the best of the candidates'
    scores; unknown ids, both fields, or a non-finite condition give 400, as
    does a condition of another width than the scorer's, which leaves a valid
    request sent beside it answered; a registered condition of the wrong
    width is refused at construction; unguided traffic still answers;
    /v1/stats has both lanes."""
    _, _, port = clip_pair
    _, _, model = _dplm_pair(np.random.default_rng(8), steps=2)
    seen = []

    def scorer(toks, mask):
        emb = port.encode_protein(toks, mask)
        seen.append((toks.clone(), emb))
        return emb

    conds = _conditions(np.random.default_rng(9))
    with pytest.raises(ValueError, match="width 31"):
        GenerateService(model, max_len=10, max_batch=4, scorer=scorer, num_candidates=3,
                        conditions={"c0": conds["one"][:31]})
    svc = GenerateService(model, max_len=10, max_batch=4, max_wait_ms=1.0, scorer=scorer,
                          num_candidates=3, conditions={"c0": conds["one"]})
    server = make_server(generate=svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_port}/v1"
    try:
        for req, cond in (({"lengths": [6, 9], "condition_id": "c0"}, conds["one"]),
                          ({"num": 2, "length": 4, "condition": conds["rows"][0].tolist()},
                           conds["rows"][0])):
            seen.clear()
            status, body = _post(f"{base}/generate", req)
            assert status == 200 and body["guided"] is True
            want_len = req.get("lengths") or [4, 4]
            assert [len(s) for s in body["sequences"]] == want_len
            assert all(set(s) <= RESIDUES for s in body["sequences"])
            (toks, emb), = seen  # one scorer call over the K x max_batch rows
            assert toks.shape == (3 * 4, 12)
            c = torch.from_numpy(cond) / np.linalg.norm(cond)
            cos = (emb / emb.norm(dim=-1, keepdim=True) @ c).reshape(3, 4)
            for i, score in enumerate(body["clip_scores"]):
                assert score == pytest.approx(float(cos[:, i].max()), abs=1e-5)
        for bad in ({"lengths": [4], "condition_id": "nope"},
                    {"lengths": [4], "condition_id": "c0", "condition": [1.0] * 32},
                    {"lengths": [4], "condition": [float("nan")] * 32},
                    {"lengths": [4], "condition": [1.0] * 31},
                    {"lengths": [4], "condition": []}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(f"{base}/generate", bad)
            assert err.value.code == 400, bad
        codes = {}

        def send(name, cond):
            try:
                codes[name] = _post(f"{base}/generate", {"lengths": [3], "condition": cond})[0]
            except urllib.error.HTTPError as err:
                codes[name] = err.code

        pair = [threading.Thread(target=send, args=a)
                for a in (("bad", [1.0] * 64), ("good", conds["one"].tolist()))]
        for t in pair:
            t.start()
        for t in pair:
            t.join()
        assert codes == {"bad": 400, "good": 200}
        status, body = _post(f"{base}/generate", {"lengths": [5]})
        assert status == 200 and "confidence" in body and "guided" not in body
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as resp:
            stats = json.loads(resp.read().decode())
        assert stats["generate_guided"]["requests"] == 5 and stats["generate"]["requests"] == 1
    finally:
        server.shutdown()
        svc.close()


def _serve_args(*extra):
    return serve.parse_args([
        "--device", "cpu", "--allow-random", "--esm", "esm2_t6_8M", "--max-len", "64",
        "--max-batch", "2", "--dplm-random", "--dplm-d-model", "64", "--dplm-layers", "1",
        "--gen-max-len", "6", "--gen-steps", "2", "--gen-max-batch", "2", *extra])


def test_serve_cli_guided_random_with_conditions(tmp_path):
    path = tmp_path / "conditions.npz"
    np.savez(path, rbp=np.random.default_rng(0).normal(size=320).astype(np.float32))
    embed_svc, gen_svc = serve.build_services(_serve_args(
        "--guided-random", "--gen-candidates", "3", "--conditions-npz", str(path)))
    try:
        assert gen_svc.num_candidates == 3 and sorted(gen_svc.conditions) == ["rbp"]
        seqs, scores = gen_svc.generate([5, 3], timeout=120, condition_id="rbp")
        assert [len(s) for s in seqs] == [5, 3] and all(-1.0 <= s <= 1.0 for s in scores)
    finally:
        embed_svc.close()
        gen_svc.close()


def test_serve_cli_guided_flags_refused():
    # a scorer bundle guides /v1/generate: without a DPLM it is refused; a
    # bundle directory that is not there is read, and fails to be
    with pytest.raises(SystemExit, match="--dplm-bundle"):
        serve.build_services(serve.parse_args(["--device", "cpu", "--no-embed",
                                               "--scorer-bundle", "bundle"]))
    with pytest.raises(FileNotFoundError, match="bundle"):
        serve.build_services(_serve_args("--scorer-bundle", "bundle"))
    with pytest.raises(SystemExit, match="--no-embed"):
        serve.build_services(_serve_args("--guided-random", "--no-embed"))


def test_generate_cli_writes_fasta_on_cpu(tmp_path, capsys):
    out = tmp_path / "gen.fasta"
    generate_cli.main(["--device", "cpu", "--output", str(out), "--length", "7", "--num", "2",
                       "--steps", "2"])
    lines = out.read_text().splitlines()
    assert len(lines) == 4 and lines[0].startswith(">generated_0 score=")
    assert len(lines[1]) == 7 and set(lines[1]) <= RESIDUES
    assert "RANDOM" in capsys.readouterr().out


def test_generate_cli_flags(tmp_path, monkeypatch):
    assert generate_cli.parse_args(["--output", "x"]).device == "cuda"
    out = str(tmp_path / "g.fasta")
    assert generate_cli.parse_args(["--output", "x"]).candidates == 8
    # the bundle flags read their bundles (tests/test_torch_pretrained.py
    # drives them on real ones): a directory that is not there fails
    for flags in (["--dplm-bundle", "b"], ["--esm-init", "b"],
                  ["--condition", "c.npz", "--scorer-bundle", "b"]):
        with pytest.raises(FileNotFoundError):
            generate_cli.main(["--device", "cpu", "--output", out, "--steps", "1", "--length",
                               "3", "--num", "1", *flags])
    with pytest.warns(UserWarning, match="UNGUIDED"):
        generate_cli.main(["--device", "cpu", "--output", out, "--length", "3", "--num", "1",
                           "--steps", "1", "--condition", "c.npz"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        generate_cli.main(["--output", out])
