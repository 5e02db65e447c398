"""The InfoNCE backward from the saved int16 raw (pass A, `sym_infonce_grad_raw`:
P·y and rowdot; pass B, `sym_infonce_grad_rawT`: P^T·x) of this checkout
against another checkout's, in turns on one card, with the bound beside them:

    python -m clip_dplm_tpu_torch.experiments.raw_ab --other DIR [--rounds N]
        [--variant] [--steps MODEL,...] [--profile MODEL,...]

DIR is another checkout of the repository (for example a parent commit
unpacked with `git archive` into a directory that `.gitignore` lists), or a
directory under `build/` holding only `clip_dplm_tpu_torch/csrc/{raw_grad.cu,
common.cuh,tma.cuh,wgmma.cuh}` (a variant of the kernel). The other tree's
`csrc/raw_grad.cu` is compiled alone with nvcc into `build/raw_ab/`, or, in a
tree from before it (the WMMA passes), its `csrc/fused_infonce.cu` (with
`infonce_tiles.cuh` and `common.cuh`); this checkout's comes from the
package's library. Both trees' C entries are called through ctypes on the
same inputs (unit rows, y pulled towards x as aligned pairs, the raw this
checkout's saving forward stores, the plain lse) at `chip_smoke.py`'s
phase-11 shapes, B = 8192, 4096, 1000, 256 and 200, d = 512. Both are held to
the plain versions (`_plain_grad_raw`, `_plain_grad_rawT`: atol = rtol = 2e-2
of the largest entry) and timed in turns other, this, this, other, `--rounds`
times (with `--variant` the other tree is a variant that leaves out part of
the work, to see what holds the kernel, and is timed without the check).
One JSON line a shape and pass, with the bound (the larger of the
bytes the call must move over 3.35 TB/s and its operations over 989 TFLOP/s),
each time over it, the blocks this tree's kernel launches and the bytes its
blocks read from L2 (the walked operand once a block, the raw once). ptxas's
registers and spills of both trees' kernels are printed first.

`--steps two_tower,tf_clip,rna_rbp` then runs each checkout's
`experiments/bench.py --model M` in processes of their own, in turns other,
this, this, other, `--rounds` times, and `--profile two_tower,tf_clip` each
checkout's `experiments/profile_step.py --model M` in a process of its own
for each model (torch.profiler shows kernels only in a process's first
session), printing the device ms a step of its InfoNCE kernels. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from clip_dplm_tpu_torch.experiments.flash_ab import cuda_ms
from clip_dplm_tpu_torch.experiments.row_ce_ab import bound, ptxas_summary
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import fused_infonce as fi

REPO = Path(__file__).resolve().parents[2]
TOL = dict(atol=2e-2, rtol=2e-2)
D = 512
SCALE = 14.2857
# chip_smoke.py's phase-11 shapes: (what, B)
SHAPES = (("two-tower", 8192), ("tf_clip pair", 4096), ("ragged", 1000), ("train CLI", 256),
          ("ragged one cluster", 200))
ENTRIES = ("sym_infonce_grad_raw", "sym_infonce_grad_rawT")
NEW_KEY = "from_raw_grad_kernel"
OLD_KEYS = ("sym_grad_raw_kernel", "sym_grad_rawT_kernel")
# the symmetric InfoNCE's kernels of either tree, as torch.profiler names them
PROFILE_KEYS = (NEW_KEY, *OLD_KEYS, "sym_grad_merged_kernel", "sum_partials_kernel",
                "lse_walk_kernel", "lse_combine_kernel")
OWN_ROWS = 64  # own entries a block of from_raw_grad_kernel


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variant", action="store_true",
                    help="the other tree leaves out part of the work: time it unchecked")
    ap.add_argument("--steps", default="", help="bench models to time in turns, comma-separated")
    ap.add_argument("--profile", default="",
                    help="bench models to profile in each tree, comma-separated")
    return ap.parse_args(argv)


def work(entry: str, m: int, n: int, d: int = D):
    """(bytes, operations) the call must move and do: the int16 raw (m x n),
    both lse and the scale in, the walked operand (y for pass A, x for pass
    B) in bf16; the f32 product out (and pass A's rowdot); the contraction's
    2·m·n·d operations. Pass A's own side is m, pass B's n."""
    raw_in = m * n * 2 + (m + n) * 4 + 4
    if entry == "sym_infonce_grad_raw":
        return raw_in + n * d * 2 + m * d * 4 + m * 4, 2.0 * m * n * d
    return raw_in + m * d * 2 + n * d * 4, 2.0 * m * n * d


def l2_bytes(entry: str, m: int, n: int, d: int = D):
    """(blocks, bytes read from L2) of this tree's kernel: one block a 64 own
    entries, each reading the whole walked operand (bf16) and its 64 own
    entries' raw once."""
    own, walked = (m, n) if entry == "sym_infonce_grad_raw" else (n, m)
    blocks = -(-own // OWN_ROWS)
    return blocks, blocks * walked * d * 2 + m * n * 2


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def build_other(other: Path) -> ctypes.CDLL:
    """The other checkout's from-raw passes, alone, as a shared library: its
    raw_grad.cu, or fused_infonce.cu from before it."""
    csrc = other / "clip_dplm_tpu_torch" / "csrc"
    src = csrc / "raw_grad.cu"
    if not src.exists():
        src = csrc / "fused_infonce.cu"
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cu*"))))
    out = REPO / "build" / "raw_ab" / f"libraw_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        for key in (NEW_KEY, *OLD_KEYS):
            for entry in ptxas_summary(proc.stdout + proc.stderr, key):
                print(json.dumps({"ptxas": "other", "kernel": key, **entry}), flush=True)
    return _bind(ctypes.CDLL(str(out)))


def inputs(B: int, seed: int = 17):
    """Unit rows x, and y pulled towards x (aligned pairs), in bf16; the raw
    this checkout's saving forward stores and the plain lse."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.nn.functional.normalize(torch.randn(B, D, generator=g, device="cuda"), dim=-1)
    y = torch.randn(B, D, generator=g, device="cuda")
    y = torch.nn.functional.normalize(x + 0.5 * torch.nn.functional.normalize(y, dim=-1), dim=-1)
    xb, yb = x.bfloat16(), y.bfloat16()
    scale = torch.tensor([SCALE], device="cuda")
    raw_q = fi._kernel_lse_save(xb, yb, scale)[2]
    lse_row, lse_col = fi._plain_lse(xb, yb, scale)
    return raw_q, xb, yb, scale, lse_row, lse_col


def _err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    scale = max(want.abs().max().item(), 1e-30)
    if not (torch.isfinite(got).all() and torch.allclose(got / scale, want / scale, **TOL)):
        raise RuntimeError(f"{what} disagrees with the plain version")
    return (got - want).abs().max().item() / scale


def kernel_turns(lib_this: ctypes.CDLL, lib_other: ctypes.CDLL, rounds: int,
                 variant: bool = False) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    for what, B in SHAPES:
        raw_q, x, y, scale, lse_row, lse_col = args = inputs(B)
        ldq = raw_q.stride(0)
        want = {"sym_infonce_grad_raw": fi._plain_grad_raw(*args),
                "sym_infonce_grad_rawT": (fi._plain_grad_rawT(*args),)}
        # the WMMA passes write whole 32-row tiles: room for 64-row ones
        out = {t: (torch.empty(-(-B // 64) * 64, D, device="cuda"), torch.empty(B, device="cuda"))
               for t in ("this", "other")}

        def call(lib, tree, entry):
            acc, rowdot = out[tree]
            if entry == "sym_infonce_grad_raw":
                rc = lib.sym_infonce_grad_raw(raw_q.data_ptr(), ldq, y.data_ptr(),
                                              scale.data_ptr(), lse_row.data_ptr(),
                                              lse_col.data_ptr(), acc.data_ptr(),
                                              rowdot.data_ptr(), B, B, D, stream)
            else:
                rc = lib.sym_infonce_grad_rawT(raw_q.data_ptr(), ldq, x.data_ptr(),
                                               scale.data_ptr(), lse_row.data_ptr(),
                                               lse_col.data_ptr(), acc.data_ptr(), B, B, D,
                                               stream)
            if rc != 0:
                raise RuntimeError(f"{tree} {entry} {what}: CUDA error {rc}")

        for entry in ENTRIES:
            fns = {tree: (lambda lib=lib, tree=tree: call(lib, tree, entry))
                   for tree, lib in (("this", lib_this), ("other", lib_other))}
            errs = {}
            for tree in ("this",) if variant else ("this", "other"):
                fns[tree]()
                torch.cuda.synchronize()
                acc, rowdot = out[tree]
                got = (acc[:B], rowdot) if entry == "sym_infonce_grad_raw" else (acc[:B],)
                errs[tree] = max(_err(a, b, f"{tree} {entry} {what}")
                                 for a, b in zip(got, want[entry]))
            times = {"this": [], "other": []}
            for _ in range(rounds):
                for tree in ("other", "this", "this", "other"):
                    times[tree].append(cuda_ms(fns[tree]))
            bound_ms, bound_by = bound(*work(entry, B, B))
            blocks, l2 = l2_bytes(entry, B, B)
            print(json.dumps({
                "kernel": entry, "shape": what, "B": B, "d": D, "this_ms": times["this"],
                "other_ms": times["other"], "bound_ms": bound_ms, "bound_by": bound_by,
                "this_over_bound": min(times["this"]) / bound_ms,
                "other_over_bound": min(times["other"]) / bound_ms, "other_is_variant": variant,
                "speedup": min(times["other"]) / min(times["this"]), "this_blocks": blocks,
                "this_l2_bytes": l2, "this_l2_tb_per_s": l2 / min(times["this"]) / 1e9,
                "max_err": errs}), flush=True)


def step_turns(other: Path, models, rounds: int) -> None:
    """Each tree's bench step in processes of their own, in turns other,
    this, this, other, `rounds` times (one JSON line a model a round): the
    host moves these steps by more than the kernels do."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import step_turns as turns

    for _ in range(rounds):
        turns(other, models)


def profile_infonce(other: Path, model: str) -> None:
    """Each tree's profile_step, in a process of its own: the device ms a
    step of its InfoNCE kernels (the from-raw passes by name, the rest
    summed)."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import _run

    for tree in ("other", "this"):
        lines = [json.loads(x) for x in _run(REPO if tree == "this" else other, "profile_step",
                                             ["--model", model, "--kernels",
                                              ",".join(PROFILE_KEYS)]).splitlines()
                 if x.startswith("{")]
        ours = [x for x in lines if any(k in x.get("kernel", "") for k in PROFILE_KEYS)]
        passes = [x for x in ours if any(k in x["kernel"] for k in (NEW_KEY, *OLD_KEYS))]
        print(json.dumps({
            "profile": model, "tree": tree,
            "from_raw_device_ms_per_step": sum(x["device_ms_per_step"] for x in passes),
            "from_raw_launches_per_step": sum(x["launches_per_step"] for x in passes),
            "infonce_device_ms_per_step": sum(x["device_ms_per_step"] for x in ours),
            "kernels": {x["kernel"][:90]: x["device_ms_per_step"] for x in ours},
            "summary": lines[-1]}), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("raw_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    lib_this = _bind(_build.LIBRARY.get())
    for entry in ptxas_summary(_build.LIBRARY.build_log, NEW_KEY):
        print(json.dumps({"ptxas": "this", "kernel": NEW_KEY, **entry}), flush=True)
    other = args.other.resolve()
    lib_other = build_other(other)
    calls = [lib_this.from_raw_grad_calls(i) for i in (0, 1)]
    kernel_turns(lib_this, lib_other, args.rounds, args.variant)
    print(json.dumps({"this_from_raw_grad_calls": {
        k: lib_this.from_raw_grad_calls(i) - calls[i] for i, k in enumerate(ENTRIES)}}))
    if args.steps:
        step_turns(other, args.steps.split(","), args.rounds)
    for model in filter(None, args.profile.split(",")):
        profile_infonce(other, model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
