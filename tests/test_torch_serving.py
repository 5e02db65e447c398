"""Port's serving layer (clip_dplm_tpu_torch/serving.py) on the CPU: the
tokenizer against the JAX package's, micro-batcher coalescing and errors,
embed-service parity with a direct forward, mixed-length generation, the
HTTP server end to end, and the serve CLI's service construction."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from clip_dplm_tpu.data import protein as jax_protein
from clip_dplm_tpu_torch.config import DPLMConfig, ESMConfig
from clip_dplm_tpu_torch.data import protein
from clip_dplm_tpu_torch.experiments import serve
from clip_dplm_tpu_torch.models.dplm import DPLM
from clip_dplm_tpu_torch.models.esm import ESMTower
from clip_dplm_tpu_torch.models.layers import init_params
from clip_dplm_tpu_torch.serving import (
    EmbedService,
    GenerateService,
    MicroBatcher,
    make_server,
)

RESIDUES = set("LAGVSERTIDPKQNFYMHWC")


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


def test_tokenizer_matches_reference(rng):
    assert protein.ESM_VOCAB == jax_protein.ESM_VOCAB
    assert (protein.CLS_IDX, protein.PAD_IDX, protein.EOS_IDX, protein.UNK_IDX,
            protein.MASK_IDX) == (jax_protein.CLS_IDX, jax_protein.PAD_IDX,
                                  jax_protein.EOS_IDX, jax_protein.UNK_IDX,
                                  jax_protein.MASK_IDX)
    seqs = [protein.random_protein(rng, n) for n in (1, 7, 40)]
    seqs += ["mk ta\tyiak", "ACDXUZOB*J", "LLLLLLLLLLLLLLLLLLLL"]
    for s in seqs:
        for max_len in (None, 12):
            for uzob in (False, True):
                np.testing.assert_array_equal(
                    protein.tokenize(s, max_len, replace_uzob=uzob),
                    jax_protein.tokenize(s, max_len, replace_uzob=uzob))
    for got, want in zip(protein.tokenize_batch(seqs, max_len=30, pad_multiple=8),
                         jax_protein.tokenize_batch(seqs, max_len=30, pad_multiple=8)):
        np.testing.assert_array_equal(got, want)
    ids = np.array([0, 5, 9, 32, 24, 2, 4, 1])
    assert protein.detokenize(ids) == jax_protein.detokenize(ids)


# ---------------------------------------------------------------------------
# MicroBatcher
# ---------------------------------------------------------------------------


def test_microbatcher_coalesces_and_preserves_order():
    seen = []

    def batch_fn(xs):
        seen.append(list(xs))
        return [x * 2 for x in xs]

    mb = MicroBatcher(batch_fn, max_batch=8, max_wait_ms=50.0)
    try:
        futs = [mb.submit(i) for i in range(20)]
        assert [f.result(timeout=10) for f in futs] == [2 * i for i in range(20)]
        assert mb.stats()["requests"] == 20
        assert mb.stats()["batches"] < 20
        assert max(len(b) for b in seen) <= 8
        assert sorted(x for b in seen for x in b) == list(range(20))
    finally:
        mb.close()


def test_microbatcher_error_propagates_then_recovers():
    def batch_fn(xs):
        if "bad" in xs:
            raise RuntimeError("poison")
        return xs

    mb = MicroBatcher(batch_fn, max_batch=4, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="poison"):
            mb("bad", timeout=10)
        assert mb("ok", timeout=10) == "ok"
        assert mb.stats()["errors"] == 1
    finally:
        mb.close()
    with pytest.raises(RuntimeError):
        mb.submit("after close")


def test_microbatcher_concurrent_submitters():
    mb = MicroBatcher(lambda xs: [x + 1 for x in xs], max_batch=16,
                      max_wait_ms=20.0)
    results = {}

    def client(i):
        results[i] = mb(i, timeout=10)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert results == {i: i + 1 for i in range(32)}
        assert mb.stats()["mean_batch_size"] > 1.0
    finally:
        mb.close()


# ---------------------------------------------------------------------------
# services
# ---------------------------------------------------------------------------


def _tiny_tower():
    tower = ESMTower(ESMConfig(d_model=32, num_layers=1, num_heads=2, max_len=96),
                     dtype=torch.float32)
    init_params(tower, torch.Generator().manual_seed(0))
    return tower.eval()


def _tiny_dplm():
    model = DPLM(DPLMConfig(d_model=32, num_layers=1, num_heads=2, max_len=32,
                            num_diffusion_steps=4), dtype=torch.float32)
    init_params(model, torch.Generator().manual_seed(0))
    return model.eval()


def test_embed_service_matches_direct_forward():
    """Buckets 16/32/96: the 70-residue sequence lands in the 96 bucket (the
    packed short-S path); the others in 16 and 32."""
    tower = _tiny_tower()
    svc = EmbedService(tower, max_len=96, max_batch=4, max_wait_ms=1.0,
                       buckets=[16, 32, 96])
    seqs = ["MKTAYIAKQR", "LA", "GVSERTIDPKQNFYMHWC", "A" * 70]
    try:
        got = np.stack([svc.embed([s], timeout=30)[0] for s in seqs])
        for s, g in zip(seqs, got):
            toks, mask = protein.tokenize_batch([s], pad_multiple=1)
            with torch.no_grad():
                want = tower(torch.from_numpy(toks), torch.from_numpy(mask),
                             pooling="mean_residues")[0].numpy()
            np.testing.assert_allclose(g, want, rtol=2e-5, atol=2e-5)
        with pytest.raises(ValueError):
            svc.embed([])
    finally:
        svc.close()


def test_generate_service_mixed_lengths():
    svc = GenerateService(_tiny_dplm(), max_len=10, max_batch=4,
                          max_wait_ms=1.0, num_steps=4)
    try:
        seqs, conf = svc.generate([4, 9, 2], timeout=60)
        assert [len(s) for s in seqs] == [4, 9, 2]
        assert all(set(s) <= RESIDUES for s in seqs)
        assert all(np.isfinite(c) for c in conf)
        with pytest.raises(ValueError, match="outside"):
            svc.generate([11])
        with pytest.raises(ValueError, match="outside"):
            svc.generate([0])
        with pytest.raises(ValueError, match="scorer"):
            svc.generate([4], condition=np.ones(8, np.float32))
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# HTTP server end to end
# ---------------------------------------------------------------------------


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read().decode())


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, json.loads(resp.read().decode())


def test_http_server_end_to_end():
    tower = _tiny_tower()
    embed_svc = EmbedService(tower, max_len=64, max_batch=4, max_wait_ms=1.0,
                             buckets=[32, 64])
    gen_svc = GenerateService(_tiny_dplm(), max_len=10, max_batch=4,
                              max_wait_ms=1.0, num_steps=4)
    server = make_server(embed=embed_svc, generate=gen_svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        assert _get(f"{base}/healthz") == (200, {"ok": True})

        status, body = _post(f"{base}/v1/embed", {"sequences": ["MKTAYIAK", "LAGV"]})
        assert status == 200
        emb = np.asarray(body["embeddings"], np.float32)
        assert emb.shape == (2, body["dim"]) and body["dim"] == 32
        toks, mask = protein.tokenize_batch(["MKTAYIAK"], pad_multiple=1)
        with torch.no_grad():
            want = tower(torch.from_numpy(toks), torch.from_numpy(mask),
                         pooling="mean_residues")[0].numpy()
        np.testing.assert_allclose(emb[0], want, rtol=2e-4, atol=2e-4)

        status, body = _post(f"{base}/v1/generate", {"lengths": [5, 8]})
        assert status == 200
        assert [len(s) for s in body["sequences"]] == [5, 8]
        assert len(body["confidence"]) == 2
        status, body = _post(f"{base}/v1/generate", {"num": 2, "length": 6})
        assert status == 200 and [len(s) for s in body["sequences"]] == [6, 6]

        status, body = _get(f"{base}/v1/stats")
        assert status == 200
        assert body["embed"]["requests"] >= 2
        assert body["generate"]["requests"] >= 4

        for path, obj in [("/v1/embed", {"sequences": []}),
                          ("/v1/generate", {"lengths": [999]}),
                          ("/v1/generate", {"lengths": [4], "condition": [1.0, 2.0]})]:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(f"{base}{path}", obj)
            assert err.value.code == 400, path
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{base}/v1/nope", {})
        assert err.value.code == 404
    finally:
        server.shutdown()
        embed_svc.close()
        gen_svc.close()


def test_http_concurrent_clients_share_batches():
    embed_svc = EmbedService(_tiny_tower(), max_len=32, max_batch=8,
                             max_wait_ms=150.0, buckets=[32])
    server = make_server(embed=embed_svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_port}"
    results = {}

    def client(i):
        results[i] = _post(f"{base}/v1/embed", {"sequences": ["MKTAYIAK"]})

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert all(status == 200 for status, _ in results.values())
        first = np.asarray(results[0][1]["embeddings"])
        for _, body in results.values():
            np.testing.assert_allclose(np.asarray(body["embeddings"]), first,
                                       rtol=1e-5, atol=1e-5)
        stats = embed_svc.batcher.stats()
        assert stats["batches"] < stats["requests"]
    finally:
        server.shutdown()
        embed_svc.close()


# ---------------------------------------------------------------------------
# serve CLI
# ---------------------------------------------------------------------------


def test_cli_builds_services_on_cpu():
    args = serve.parse_args([
        "--device", "cpu", "--allow-random", "--esm", "esm2_t6_8M",
        "--max-len", "64", "--max-batch", "2", "--dplm-random",
        "--dplm-d-model", "64", "--dplm-layers", "1", "--gen-max-len", "6",
        "--gen-steps", "2", "--gen-max-batch", "2"])
    embed_svc, gen_svc = serve.build_services(args)
    try:
        emb = embed_svc.embed(["MKTAYIAK"], timeout=60)
        assert emb.shape == (1, 320) and np.isfinite(emb).all()
        seqs, conf = gen_svc.generate([5], timeout=60)
        assert len(seqs[0]) == 5 and set(seqs[0]) <= RESIDUES
    finally:
        embed_svc.close()
        gen_svc.close()


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.build_services(serve.parse_args(["--allow-random"]))
