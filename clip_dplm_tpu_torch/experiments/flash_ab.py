"""The flash-attention forward (or, with `--bwd`, backward) of this checkout
against another checkout's, in turns on one card, with SDPA and the bound
beside them:

    python -m clip_dplm_tpu_torch.experiments.flash_ab --other DIR [--rounds N]
        [--server] [--bwd]

DIR is another checkout of the repository (for example a parent commit
unpacked with `git archive` into a directory that `.gitignore` lists). Its
`clip_dplm_tpu_torch/csrc/flash_attention.cu` is compiled alone with nvcc
into `build/flash_ab/`, and its C entry `flash_attention_fwd` (q, k, v,
mask, out, lse, B, H, S, Sk, Dh, scale, stream) is called through ctypes on
the same inputs as this checkout's `flash_attention`. Both are held against
the plain version (atol = rtol = 2e-2, bf16) and timed in turns other,
this, this, other, `--rounds` times, at ESM-2 650M's embed shape (32, 20,
1024, 64) with ragged lengths and at the tf_clip cell tower's (1, 8, 4096,
64) with a degree-style mask (~5 % of the keys masked). One JSON line per
shape.

With `--bwd`, the two backward kernels instead: each tree's C entries
`flash_attention_bwd_dq` and `flash_attention_bwd_dkv` (q, k, v, mask, dout,
lse, delta, dq or dk and dv, B, H, S, Sk, Dh, scale, stream) on the same
inputs (the plain forward's out and lse, delta = rowsum(dO∘O)), held against
`flash_attention_bwd_reference` (atol = rtol = 2e-2 of each output's largest
entry) and timed in turns other, this, this, other at `chip_smoke.py` 9(a)'s
three shapes: the cell tower's (1, 8, 4096, 64) with a degree-style mask,
ESM-2 650M's (32, 20, 1024, 64) ragged and (4, 8, 300, 64) ragged. Beside
them SDPA's whole backward (one autograd call on a retained graph) and each
kernel's bound. One JSON line per shape; a variant of the kernel is tried
the same way (a directory holding only `clip_dplm_tpu_torch/csrc/
{flash_attention.cu,common.cuh,tma.cuh,wgmma.cuh}` is a valid DIR).

With `--server`, the server phase of each checkout's `chip_smoke.py` (ESM-2
650M embed and DPLM generate at full width, random weights) runs in a
process of its own, in turns other, this, this, other; one JSON line gives
each run's `embed L=...` rates and its flash-attention launch count.

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import flash_attention as fa
from clip_dplm_tpu_torch.ops.attention import attention_reference
from clip_dplm_tpu_torch.ops.flash_attention import flash_attention

REPO = Path(__file__).resolve().parents[2]
PEAK_BF16 = 989e12  # H100 SXM dense bf16
HBM_BYTES_PER_S = 3.35e12
TOL = dict(atol=2e-2, rtol=2e-2)
SHAPES = ((32, 20, 1024, 64, "ragged"), (1, 8, 4096, 64, "degree"))
BWD_SHAPES = ((1, 8, 4096, 64, "degree"), (32, 20, 1024, 64, "ragged"), (4, 8, 300, 64, "ragged"))
BWD_ENTRIES = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def build_other(other: Path) -> ctypes.CDLL:
    """The other checkout's flash_attention.cu, alone, as a shared library."""
    src = other / "clip_dplm_tpu_torch" / "csrc" / "flash_attention.cu"
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(src.parent.glob("*.cu*"))))
    out = REPO / "build" / "flash_ab" / f"libflash_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        for line in ptxas_lines(proc.stdout + proc.stderr, "flash_"):
            print("other ptxas:", line)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [P] * 6 + [I] * 5 + [F, P]
    lib.flash_attention_bwd_dq.argtypes = [P] * 8 + [I] * 5 + [F, P]
    lib.flash_attention_bwd_dkv.argtypes = [P] * 9 + [I] * 5 + [F, P]
    for name in ("flash_attention_fwd", *BWD_ENTRIES):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def ptxas_lines(log: str, key: str):
    """ptxas's report (entry, spills, registers) of each kernel whose
    mangled name holds `key`."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and key in line:
            yield from (x.strip() for x in lines[i:i + 4])


def cuda_ms(fn, iters: int = 20) -> float:
    """Device ms per call, the calls queued behind a sleeping kernel so that
    the events time the device work back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(B, H, S, Dh, kind, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, H, S, Dh, generator=g, device="cuda").bfloat16() for _ in range(3))
    if kind == "degree":
        mask = torch.rand(B, S, generator=g, device="cuda") > 0.05
    else:
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device="cuda")
        lens[0] = S
        mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
    return q, k, v, mask


def kernel_turns(lib, rounds: int) -> None:
    for B, H, S, Dh, kind in SHAPES:
        q, k, v, mask = inputs(B, H, S, Dh, kind)
        mask_u8 = mask.to(torch.uint8).contiguous()
        out_o = torch.empty_like(q)
        lse_o = torch.empty(B, H, S, dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def other():
            rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         mask_u8.data_ptr(), out_o.data_ptr(), lse_o.data_ptr(),
                                         B, H, S, S, Dh, 1.0 / Dh ** 0.5, stream)
            if rc != 0:
                raise RuntimeError(f"other flash_attention_fwd: CUDA error {rc}")
            return out_o

        def this():
            with torch.no_grad():
                return flash_attention(q, k, v, mask=mask)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None, None, :])

        want = attention_reference(q, k, v, mask=mask).float()
        errs = {}
        for name, fn in (("this", this), ("other", other)):
            got = fn().float()
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and torch.allclose(got, want, **TOL)):
                raise RuntimeError(f"{name} flash forward disagrees with the plain version "
                                   f"at {(B, H, S, Dh)}")
            errs[name] = (got - want).abs().max().item()
        times = {"this": [], "other": []}
        for _ in range(rounds):
            for name in ("other", "this", "this", "other"):
                times[name].append(cuda_ms(this if name == "this" else other))
        sdpa_ms = min(cuda_ms(sdpa), cuda_ms(sdpa))
        ops = 4 * B * H * S * S * Dh
        nbytes = 4 * B * H * S * Dh * 2 + B * S
        bound = max(ops / PEAK_BF16, nbytes / HBM_BYTES_PER_S) * 1e3
        print(json.dumps({
            "shape": [B, H, S, Dh], "mask": kind, "this_ms": times["this"],
            "other_ms": times["other"], "sdpa_ms": sdpa_ms, "bound_ms": bound,
            "this_tflops": ops / min(times["this"]) / 1e9,
            "max_abs_err": errs}))


def bwd_turns(lib, rounds: int) -> None:
    """Both trees' backward kernels at BWD_SHAPES, in turns."""
    for B, H, S, Dh, kind in BWD_SHAPES:
        q, k, v, mask = inputs(B, H, S, Dh, kind)
        dout = torch.randn(B, H, S, Dh, generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda").bfloat16()
        out = attention_reference(q, k, v, mask=mask)
        lse = fa.flash_lse_reference(q, k, mask).float().contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
        mask_u8 = mask.to(torch.uint8).contiguous()
        stream = torch.cuda.current_stream().cuda_stream
        outs = {tree: [torch.empty_like(q) for _ in range(3)] for tree in ("this", "other")}
        ptrs = [t.data_ptr() for t in (q, k, v, mask_u8, dout, lse, delta)]
        dims = (B, H, S, S, Dh, 1.0 / Dh ** 0.5, stream)
        libs = {"this": _build.LIBRARY.get(), "other": lib}

        def call(tree, entry):
            dq, dk, dv = outs[tree]
            res = (dq,) if entry == BWD_ENTRIES[0] else (dk, dv)
            rc = getattr(libs[tree], entry)(*ptrs, *(t.data_ptr() for t in res), *dims)
            if rc != 0:
                raise RuntimeError(f"{tree} {entry}: CUDA error {rc}")

        want = fa.flash_attention_bwd_reference(q, k, v, mask, out, lse, dout)
        errs = {}
        for tree in ("this", "other"):
            for entry in BWD_ENTRIES:
                call(tree, entry)
            torch.cuda.synchronize()
            errs[tree] = []
            for name, got, ref in zip(("dq", "dk", "dv"), outs[tree], want):
                got, ref = got.float(), ref.float()
                top = max(ref.abs().max().item(), 1e-30)
                if not (torch.isfinite(got).all() and torch.allclose(got / top, ref / top, **TOL)):
                    raise RuntimeError(f"{tree} {name} disagrees with the plain version at "
                                       f"{(B, H, S, Dh)}")
                errs[tree].append((got - ref).abs().max().item() / top)
        times = {f"{tree}_{entry[20:]}_ms": [] for tree in ("this", "other")
                 for entry in BWD_ENTRIES}
        for _ in range(rounds):
            for tree in ("other", "this", "this", "other"):
                for entry in BWD_ENTRIES:
                    times[f"{tree}_{entry[20:]}_ms"].append(
                        cuda_ms(lambda: call(tree, entry)))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        y = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                             attn_mask=mask[:, None, None, :])
        sdpa = lambda: torch.autograd.grad(y, leaves, dout, retain_graph=True)  # noqa: E731
        sdpa_ms = min(cuda_ms(sdpa), cuda_ms(sdpa))
        n, prod = B * H * S * Dh, 2 * B * H * S * S * Dh
        common = 4 * n * 2 + 2 * B * H * S * 4 + B * S  # q, k, v, dO, lse, delta, mask
        bound = {"dq": max(3 * prod / PEAK_BF16, (common + n * 2) / HBM_BYTES_PER_S) * 1e3,
                 "dkv": max(4 * prod / PEAK_BF16, (common + 2 * n * 2) / HBM_BYTES_PER_S) * 1e3}
        best = {tree: sum(min(times[f"{tree}_{e}_ms"]) for e in ("dq", "dkv"))
                for tree in ("this", "other")}
        print(json.dumps({
            "shape": [B, H, S, Dh], "mask": kind, **times, "this_pair_ms": best["this"],
            "other_pair_ms": best["other"], "sdpa_bwd_ms": sdpa_ms,
            "bound_ms": bound, "max_abs_err_rel": errs}))


def server_turns(other: Path) -> None:
    code = ("import torch, chip_smoke\n"
            "from clip_dplm_tpu_torch.ops import _build\n"
            "_build.LIBRARY.get()\n"
            "chip_smoke.phase_server(torch, _build)\n")
    runs = []
    for tree in (other, REPO, REPO, other):
        env = dict(os.environ, PYTHONPATH=str(tree))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"server phase in {tree} failed:\n{proc.stdout[-3000:]}"
                               f"{proc.stderr[-3000:]}")
        rates = {m.group(1): float(m.group(2)) for m in
                 re.finditer(r"service (embed L=\d+): ([0-9.]+) seqs/s", proc.stdout)}
        launches = ast.literal_eval(re.search(r"launches during the server phase: (\{.*\})",
                                              proc.stdout).group(1))
        runs.append({"tree": "this" if tree == REPO else "other", "rates": rates,
                     "flash_attention_launches": launches["flash_attention"],
                     "seconds": time.perf_counter() - t0})
    print(json.dumps({"server_turns": runs}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--server", action="store_true")
    ap.add_argument("--bwd", action="store_true",
                    help="the backward kernels instead of the forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    _build.LIBRARY.get()
    for line in ptxas_lines(_build.LIBRARY.build_log, "flash_"):
        print("this ptxas:", line)
    lib = build_other(args.other.resolve())
    if args.bwd:
        bwd_turns(lib, args.rounds)
    else:
        kernel_turns(lib, args.rounds)
    if args.server:
        server_turns(args.other.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
