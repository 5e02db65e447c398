"""Smoke run of the PyTorch/CUDA port (clip_dplm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each fatal on failure (non-zero exit, no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from clip_dplm_tpu_torch/csrc/*.cu with nvcc;
  3. each kernel against its plain PyTorch version on the card, in bf16, at
     the serving path's shapes (bound atol = rtol = 2e-2), with both times;
  4. DPLM 640/12/10 logits on the card (kernel path) against the same
     weights on the CPU (plain path), bf16 on both, at S = 128 and 300;
  5. the HTTP server of experiments/serve.py on port 0 with random weights at
     full width (DPLM 640/12/10, 100 steps, 32 rows; ESM-2 650M, 32 rows, up
     to 1024 tokens): /healthz, /v1/embed across the 64..1024 buckets,
     /v1/generate; every launch counter must rise during this phase.
Prints a JSON line of per-kernel results, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

TOL = dict(atol=2e-2, rtol=2e-2)  # the JAX suite's bf16 kernel bound
# Whole-model bound (bf16 on both sides, different summation orders): 3x the
# bf16-vs-f32 noise of this model on the CPU (rel L2 0.010, max abs 0.038).
MODEL_REL_L2, MODEL_MAX_ABS = 3e-2, 0.12
KERNELS = {  # launch-counter name -> (source, TPU kernel it replaces)
    "short_attention": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                        "clip_dplm_tpu/ops/short_attention.py:142"),
    "short_attention_out_proj": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                                 "clip_dplm_tpu/ops/short_attention.py:142"),
    "flash_attention": ("clip_dplm_tpu_torch/csrc/flash_attention.cu",
                        "clip_dplm_tpu/ops/flash_attention.py:50"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call of fn, host launch overhead excluded: the calls
    are queued behind a sleeping kernel (~25 ms, longer than the host takes
    to enqueue them), so the events time the device work back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if enqueue_ms > 20.0:  # the sleep may have ended first: host gaps counted
        print(f"note: enqueueing the timed calls took {enqueue_ms:.1f} ms")
    return ms / iters


def compare(torch, name, shape, kernel_fn, plain_fn, results):
    """Kernel vs plain on the same inputs: error and both device times
    (timed in turns plain, kernel, kernel, plain; the lower of each pair is
    kept). A time covers all device work of the call, the wrapper's small
    set-up kernels included."""
    got, want = kernel_fn().float(), plain_fn().float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite output")
    check(torch.allclose(got, want, **TOL),
          f"{name} {shape}: max abs err {err} outside atol=rtol=2e-2")
    p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    ms, plain_ms = min(k1, k2), min(p1, p2)
    print(f"kernel {name} {shape}: max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}")
    entry = results.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry.setdefault("ms", ms)  # the first shape listed is the main one
    entry.setdefault("plain_ms", plain_ms)


def phase_kernels(torch, results):
    from clip_dplm_tpu_torch.ops.attention import attention_reference
    from clip_dplm_tpu_torch.ops.flash_attention import flash_attention
    from clip_dplm_tpu_torch.ops.short_attention import (
        out_projection,
        out_projection_reference,
        short_attention_qkv,
        short_attention_qkv_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    # packed short-S kernel: DPLM generate (640/10) and ESM-2 650M (1280/20)
    for D, H in ((640, 10), (1280, 20)):
        B, S = 32, 128
        qkv = torch.randn(B, S, 3 * D, generator=g, device=dev).to(torch.bfloat16)
        mask, pos = ragged_mask(B, S), torch.arange(S, device=dev)
        shape = f"B={B} S={S} D={D} H={H} rope"
        compare(torch, "short_attention", shape,
                lambda: short_attention_qkv(qkv, H, mask=mask, rope_positions=pos),
                lambda: short_attention_qkv_reference(qkv, H, mask=mask,
                                                      rope_positions=pos),
                results)
        o = short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos)
        wo = torch.randn(D, D, generator=g, device=dev) / D ** 0.5
        bo = torch.randn(D, generator=g, device=dev) * 0.1
        compare(torch, "short_attention_out_proj", f"M={B * S} N=K={D}",
                lambda: out_projection(o, wo, bo),
                lambda: out_projection_reference(o, wo, bo), results)
    # flash kernel: ESM-2 650M embed, the 32-row 1024 bucket, then a ragged
    # last key tile (S=1000) and the smallest flash bucket
    for B, S in ((32, 1024), (8, 1000), (8, 256)):
        H, Dh = 20, 64
        q, k, v = (torch.randn(B, H, S, Dh, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        mask = ragged_mask(B, S)
        compare(torch, "flash_attention", f"B={B} H={H} S={S} Dh={Dh}",
                lambda: flash_attention(q, k, v, mask=mask),
                lambda: attention_reference(q, k, v, mask=mask), results)


def phase_model(torch):
    from clip_dplm_tpu_torch.config import DPLMConfig
    from clip_dplm_tpu_torch.models.dplm import DPLM
    from clip_dplm_tpu_torch.models.layers import init_params

    cfg = DPLMConfig(max_len=302)
    gpu = DPLM(cfg, device="cuda")
    init_params(gpu, torch.Generator(device="cuda").manual_seed(1))
    cpu = DPLM(cfg)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(2)
    for S in (128, 300):
        toks = torch.randint(4, 24, (2, S), generator=g)
        toks[:, 0], toks[0, -1] = 0, 2
        L = 2 * S // 3  # second row ragged
        toks[1, L], toks[1, L + 1:] = 2, 1
        valid = toks != 1
        with torch.inference_mode():
            got = gpu(toks.cuda()).cpu()
            want = cpu(toks)
        check(got.shape == (2, S, cfg.vocab_size), f"logits shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"S={S}: non-finite logits")
        d = (got - want)[valid]
        rel = (d.norm() / want[valid].norm()).item()
        mx = d.abs().max().item()
        print(f"model DPLM 640/12/10 B=2 S={S}: card (kernels) vs CPU (plain): "
              f"rel_l2={rel:.3e} max_abs={mx:.3e}")
        check(rel <= MODEL_REL_L2 and mx <= MODEL_MAX_ABS,
              f"S={S}: logits outside rel_l2 <= {MODEL_REL_L2}, max_abs <= {MODEL_MAX_ABS}")


def _post(url, obj, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def phase_server(torch, build):
    from clip_dplm_tpu_torch.data.protein import RESIDUES, random_protein
    from clip_dplm_tpu_torch.experiments import serve
    from clip_dplm_tpu_torch.serving import make_server

    args = serve.parse_args([
        "--device", "cuda", "--allow-random", "--esm", "esm2_t33_650M",
        "--max-len", "1024", "--max-batch", "32", "--dplm-random",
        "--dplm-d-model", "640", "--dplm-layers", "12", "--gen-max-len", "126",
        "--gen-steps", "100", "--gen-max-batch", "32", "--port", "0"])
    dim = serve.esm_config_from_name(args.esm).d_model
    embed_svc, gen_svc = serve.build_services(args)
    server = make_server(embed=embed_svc, generate=gen_svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    rng = np.random.default_rng(0)
    residues = set(RESIDUES)
    rates = {}
    try:
        build.LAUNCHES.reset()
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            check(json.loads(resp.read().decode()) == {"ok": True}, "healthz")
        # one request per bucket group: 64, 128 (packed kernel), 512, 1024 (flash)
        for lens in ((50, 60), (100, 120), (300,), (900, 1000)):
            seqs = [random_protein(rng, n) for n in lens]
            status, body = _post(f"{base}/v1/embed", {"sequences": seqs})
            emb = np.asarray(body["embeddings"], np.float32)
            check(status == 200 and body["dim"] == dim and emb.shape == (len(lens), dim),
                  f"embed {lens}: status {status}, shape {emb.shape}")
            check(bool(np.isfinite(emb).all()), f"embed {lens}: non-finite")
        for req, want in (({"lengths": [60, 124]}, [60, 124]),
                          ({"num": 4, "length": 100}, [100] * 4)):
            status, body = _post(f"{base}/v1/generate", req)
            seqs = body["sequences"]
            check(status == 200 and [len(s) for s in seqs] == want,
                  f"generate {req}: status {status}, lengths {[len(s) for s in seqs]}")
            check(all(set(s) <= residues for s in seqs), f"generate {req}: non-residue")
            check(all(np.isfinite(body["confidence"])), f"generate {req}: confidence")
        # full batches: one 32-row program each
        t0 = time.perf_counter()
        status, body = _post(f"{base}/v1/generate", {"num": 32, "length": 126})
        rates["generate L=126 100 steps"] = 32 / (time.perf_counter() - t0)
        check(status == 200 and len(body["sequences"]) == 32, "generate x32")
        for n in (100, 300, 1000):
            seqs = [random_protein(rng, n) for _ in range(32)]
            t0 = time.perf_counter()
            status, body = _post(f"{base}/v1/embed", {"sequences": seqs})
            rates[f"embed L={n}"] = 32 / (time.perf_counter() - t0)
            check(status == 200 and len(body["embeddings"]) == 32, f"embed x32 L={n}")
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()
    finally:
        server.shutdown()
        server.server_close()
        embed_svc.close()
        gen_svc.close()
    for name, rate in rates.items():
        print(f"service {name}: {rate:.2f} seqs/s (one request of 32 sequences)")
    print(f"launches during the server phase: {launches}")
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the server path")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from clip_dplm_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.LIBRARY.get()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.LIBRARY.build_seconds:.1f} s) "
          f"-> {_build.LIBRARY.path}")
    for line in _build.LIBRARY.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    results = {}
    phase_kernels(torch, results)
    phase_model(torch)
    launches = phase_server(torch, _build)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
