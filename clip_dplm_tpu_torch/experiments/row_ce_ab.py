"""The row cross-entropy's backward kernels (csrc/row_ce.cu: `row_ce_dx`, P·y
with rowsum(p·raw), and `row_ce_dy`, P^T·x) of this checkout against another
checkout's, in turns on one card, with the bound beside them:

    python -m clip_dplm_tpu_torch.experiments.row_ce_ab --other DIR [--rounds N]
        [--steps MODEL,...] [--profile MODEL]

DIR is another checkout of the repository (for example a parent commit
unpacked with `git archive` into a directory that `.gitignore` lists), or a
directory under `build/` holding only
`clip_dplm_tpu_torch/csrc/{row_ce.cu,common.cuh,tma.cuh,wgmma.cuh}` (a
variant of the kernel). Its `row_ce.cu` is compiled alone
with nvcc into `build/row_ce_ab/`; this checkout's comes from the package's
library. Both trees' C entries are called through ctypes on the same inputs
(unit rows, the first min(m, n) of x pulled towards y's, the plain lse) at
`chip_smoke.py`'s three phase-10 shapes, d = 512: the cached step's
a -> [b; cache] (m = 8192 against 16384 rows, n_valid = 13192, dY for b's
8192 rows), b -> a (8192 x 8192) and a ragged 1000 x 1777 with n_valid =
1400. Both are held against the plain versions (`_plain_row_dx`,
`_plain_row_dy`; atol = rtol = 2e-2 of the largest entry) and timed in turns
other, this, this, other, `--rounds` times. One JSON line per shape and
kernel, with the bound (the larger of the bytes the call must move over 3.35
TB/s and its operations over 989 TFLOP/s) and each time over it. ptxas's
registers, stack frame and spill bytes of each instance of both trees' grad
kernels are printed first.

`--steps two_tower_cached` then runs each checkout's `experiments/bench.py
--model M` in a process of its own, in turns other, this, this, other,
`--rounds` times, and
`--profile two_tower_cached` each checkout's `experiments/profile_step.py
--model M` in a process of its own (torch.profiler shows kernels only in a
process's first session), printing the device ms a step of its row-CE
kernels. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from clip_dplm_tpu_torch.experiments.flash_ab import cuda_ms
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import fused_infonce as fi

REPO = Path(__file__).resolve().parents[2]
PEAK_BF16 = 989e12  # H100 SXM dense bf16
HBM_BYTES_PER_S = 3.35e12
TOL = dict(atol=2e-2, rtol=2e-2)
D = 512
SCALE = 14.2857
# (what, m, n, n_valid, rows of y whose gradient is formed): chip_smoke.py's
# CACHE_SHAPES
SHAPES = (("a->[b; cache]", 8192, 16384, 8192 + 5000, 8192),
          ("b->a", 8192, 8192, 8192, 8192),
          ("ragged", 1000, 1777, 1400, 1777))
ENTRIES = ("row_ce_dx", "row_ce_dy")
GRAD_KEY = "row_ce_grad_kernel"  # in the kernel's mangled name


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", default="", help="bench models to time in turns, comma-separated")
    ap.add_argument("--profile", default="", help="a bench model to profile in each tree")
    return ap.parse_args(argv)


def work(kernel: str, m: int, nv: int, rows: int, d: int = D):
    """(bytes, operations) the call must move and do: dx reads x, y's valid
    rows and the lse and writes P·y (f32) and rowdot, over the raw tile and
    the contraction (4·m·n_valid·d); dy reads x, y's first `rows` rows and
    the lse and writes P^T·x (f32), over 4·m·rows·d."""
    if kernel == "row_ce_dx":
        return (m + nv) * d * 2 + m * 4 + m * d * 4 + m * 4, 4.0 * m * nv * d
    return (m + rows) * d * 2 + m * 4 + rows * d * 4, 4.0 * m * rows * d


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the bf16 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(log: str, key: str = GRAD_KEY):
    """{"instance", "registers", "stack_frame", "spill_stores", "spill_loads"}
    (the last three in bytes) of each kernel whose mangled name holds `key`,
    its template arguments as <a, b> (bools as 0/1), from nvcc's -Xptxas=-v
    report."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        found = re.search(key + r"I((?:L[ib]\d+E)+)E", line)
        if "Compiling entry" not in line or not found:
            continue
        near = " ".join(lines[i:i + 4])
        regs = re.search(r"Used (\d+) registers", near)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", near)
        yield {"instance": "<" + ", ".join(re.findall(r"L[ib](\d+)E", found.group(1))) + ">",
               "registers": int(regs.group(1)) if regs else None,
               **{k: int(spill.group(i + 1)) if spill else None
                  for i, k in enumerate(("stack_frame", "spill_stores", "spill_loads"))}}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def build_other(other: Path) -> ctypes.CDLL:
    """The other checkout's row_ce.cu, alone, as a shared library."""
    csrc = other / "clip_dplm_tpu_torch" / "csrc"
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cu*"))))
    out = REPO / "build" / "row_ce_ab" / f"librow_ce_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
               str(csrc / "row_ce.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        for entry in ptxas_summary(proc.stdout + proc.stderr):
            print(json.dumps({"ptxas": "other", **entry}), flush=True)
    return _bind(ctypes.CDLL(str(out)))


def inputs(m: int, n: int, seed: int = 13):
    """Unit rows x (m, D), y (n, D) in bf16, the first min(m, n) rows of x
    pulled towards y's (aligned pairs, as a trained model's)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.nn.functional.normalize(torch.randn(m, D, generator=g, device="cuda"), dim=-1)
    y = torch.nn.functional.normalize(torch.randn(n, D, generator=g, device="cuda"), dim=-1)
    k = min(m, n)
    x[:k] = torch.nn.functional.normalize(x[:k] + y[:k], dim=-1)
    return x.bfloat16(), y.bfloat16()


def _err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    scale = max(want.abs().max().item(), 1e-30)
    if not (torch.isfinite(got).all() and torch.allclose(got / scale, want / scale, **TOL)):
        raise RuntimeError(f"{what} disagrees with the plain version")
    return (got - want).abs().max().item() / scale


def kernel_turns(lib_this: ctypes.CDLL, lib_other: ctypes.CDLL, rounds: int) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    scale = torch.tensor([SCALE], device="cuda")
    for what, m, n, nv, rows in SHAPES:
        x, y = inputs(m, n)
        y_own = y[:rows].contiguous()
        nvt = torch.tensor([nv], dtype=torch.int32, device="cuda")
        lse = fi._plain_row_lse(x, y, scale, nvt)
        want = {"row_ce_dx": fi._plain_row_dx(x, y, scale, lse, nvt),
                "row_ce_dy": (fi._plain_row_dy(x, y, scale, lse, rows),)}
        # the parent's kernels write whole 32-row tiles: room for 64-row ones
        out = {t: (torch.empty(-(-max(m, rows) // 64) * 64, D, device="cuda"),
                   torch.empty(m, device="cuda")) for t in ("this", "other")}

        def call(lib, tree, kernel):
            acc, rowdot = out[tree]
            if kernel == "row_ce_dx":
                rc = lib.row_ce_dx(x.data_ptr(), y.data_ptr(), scale.data_ptr(), nvt.data_ptr(),
                                   lse.data_ptr(), acc.data_ptr(), rowdot.data_ptr(), m, n, D,
                                   stream)
            else:
                rc = lib.row_ce_dy(x.data_ptr(), y_own.data_ptr(), scale.data_ptr(),
                                   lse.data_ptr(), acc.data_ptr(), m, rows, D, stream)
            if rc != 0:
                raise RuntimeError(f"{tree} {kernel} {what}: CUDA error {rc}")

        for kernel in ENTRIES:
            own = m if kernel == "row_ce_dx" else rows
            fns = {tree: (lambda lib=lib, tree=tree: call(lib, tree, kernel))
                   for tree, lib in (("this", lib_this), ("other", lib_other))}
            errs = {}
            for tree in ("this", "other"):
                fns[tree]()
                torch.cuda.synchronize()
                acc, rowdot = out[tree]
                got = (acc[:own], rowdot) if kernel == "row_ce_dx" else (acc[:own],)
                errs[tree] = max(_err(a, b, f"{tree} {kernel} {what}")
                                 for a, b in zip(got, want[kernel]))
            times = {"this": [], "other": []}
            for _ in range(rounds):
                for tree in ("other", "this", "this", "other"):
                    times[tree].append(cuda_ms(fns[tree]))
            bound_ms, bound_by = bound(*work(kernel, m, nv, rows))
            print(json.dumps({
                "kernel": kernel, "shape": what, "m": m, "n": n, "n_valid": nv, "rows": rows,
                "d": D, "this_ms": times["this"], "other_ms": times["other"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "this_over_bound": min(times["this"]) / bound_ms,
                "other_over_bound": min(times["other"]) / bound_ms,
                "speedup": min(times["other"]) / min(times["this"]), "max_err": errs}),
                flush=True)


def step_turns(other: Path, models, rounds: int) -> None:
    """Each tree's bench step in processes of their own, in turns other,
    this, this, other, `rounds` times (one JSON line a model a round): the
    host moves these steps by more than the kernels do."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import step_turns as turns

    for _ in range(rounds):
        turns(other, models)


def profile_row_ce(other: Path, model: str) -> None:
    """Each tree's profile_step, in a process of its own: the device ms a
    step of its row-CE kernels."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import _run

    for tree in ("other", "this"):
        lines = [json.loads(x) for x in _run(REPO if tree == "this" else other, "profile_step",
                                             ["--model", model]).splitlines()
                 if x.startswith("{")]
        ce = [x for x in lines if "row_ce" in x.get("kernel", "")]
        print(json.dumps({
            "profile": model, "tree": tree,
            "row_ce_device_ms_per_step": sum(x["device_ms_per_step"] for x in ce),
            "row_ce_launches_per_step": sum(x["launches_per_step"] for x in ce),
            "kernels": {x["kernel"][:90]: x["device_ms_per_step"] for x in ce},
            "summary": lines[-1]}), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("row_ce_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    other = args.other.resolve()
    lib_this = _bind(_build.LIBRARY.get())
    for entry in ptxas_summary(_build.LIBRARY.build_log):
        print(json.dumps({"ptxas": "this", **entry}), flush=True)
    lib_other = build_other(other)
    calls = [lib_this.row_ce_grad_calls(i) for i in (0, 1)]
    kernel_turns(lib_this, lib_other, args.rounds)
    print(json.dumps({"this_row_ce_grad_kernel_calls": {
        k: lib_this.row_ce_grad_calls(i) - calls[i] for i, k in enumerate(ENTRIES)}}))
    if args.steps:
        step_turns(other, args.steps.split(","), args.rounds)
    if args.profile:
        profile_row_ce(other, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
