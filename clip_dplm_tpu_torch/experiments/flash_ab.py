"""The flash-attention forward of this checkout against another checkout's,
in turns on one card, with SDPA and the bound beside them:

    python -m clip_dplm_tpu_torch.experiments.flash_ab --other DIR [--rounds N] [--server]

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
from clip_dplm_tpu_torch.ops.attention import attention_reference
from clip_dplm_tpu_torch.ops.flash_attention import flash_attention

REPO = Path(__file__).resolve().parents[2]
PEAK_BF16 = 989e12  # H100 SXM dense bf16
HBM_BYTES_PER_S = 3.35e12
TOL = dict(atol=2e-2, rtol=2e-2)
SHAPES = ((32, 20, 1024, 64, "ragged"), (1, 8, 4096, 64, "degree"))


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
        for line in ptxas_lines(proc.stdout + proc.stderr, "flash_fwd"):
            print("other ptxas:", line)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [P] * 6 + [I] * 5 + [F, P]
    lib.flash_attention_fwd.restype = ctypes.c_int
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    _build.LIBRARY.get()
    for line in ptxas_lines(_build.LIBRARY.build_log, "flash_fwd"):
        print("this ptxas:", line)
    kernel_turns(build_other(args.other.resolve()), args.rounds)
    if args.server:
        server_turns(args.other.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
