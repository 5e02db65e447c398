"""The symmetric InfoNCE's recompute pass (`sym_infonce_grad`: (P_row +
P_col^T)·y and rowsum(p·raw)) of this checkout against another checkout's, in
turns on one card, with the bound beside them:

    python -m clip_dplm_tpu_torch.experiments.sym_ab --other DIR [--rounds N]
        [--steps STEP,...] [--profile STEP]

DIR is another checkout of the repository (for example a parent commit
unpacked with `git archive` into a directory that `.gitignore` lists), or a
directory under `build/` holding only `clip_dplm_tpu_torch/csrc/{row_ce.cu,
common.cuh,tma.cuh,wgmma.cuh}` (a variant of the kernel). The other tree's
`csrc/row_ce.cu` is compiled alone with nvcc into `build/sym_ab/` where it
holds the C entry `sym_infonce_grad`, else (a tree from before it, whose
entry is the WMMA kernel) its `csrc/fused_infonce.cu` with the headers it
includes; this checkout's comes from the package's library. Both trees' C
entries are called through ctypes on the same inputs (unit rows, x pulled
towards y as aligned pairs, the plain lse) at `chip_smoke.py`'s phase-6
batches, B = 8192, 4096 and a ragged 1000, and at B = 32768 (past the 640
MiB at which "auto" stops saving the raw), d = 512. Both are held to the
plain version (`_plain_grad`: atol = rtol = 2e-2 of the largest entry), this
tree's two launches must be equal byte for byte, and both are timed in turns
other, this, this, other, `--rounds` times. One JSON line a batch, with the
bound (the larger of the bytes the call must move over 3.35 TB/s and its
operations over 989 TFLOP/s) and each time over it. ptxas's registers and
spills of both trees' kernels are printed first (this tree's
`row_ce_grad_kernel<KB, mode>`, mode 0 dX, 1 dY, 2 sym).

`--steps never8192,auto32768` then runs each checkout's
`experiments/bench.py` two-tower step in processes of their own, in turns
other, this, this, other, `--rounds` times: at B = 8192 with
`-o contrastive.fused_materialize_raw=never` (the recompute pass) and at B =
32768 under "auto" (past 640 MiB: the recompute pass). `--profile auto32768`
runs each checkout's `experiments/profile_step.py` on that step in a
process of its own (torch.profiler shows kernels only in a process's first
session), printing the device ms a step of its recompute-pass kernel. Needs
a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
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
# chip_smoke.py's phase-6 batches (SYM_GRAD_SHAPES), then past "auto"'s limit
SHAPES = (("B=8192", 8192), ("B=4096", 4096), ("ragged", 1000), ("B=32768", 32768))
ENTRY = "sym_infonce_grad"
SYM_MODE = 2  # row_ce_grad_calls(2): the symmetric mode's launches
# --steps / --profile name -> (batch, overrides) of the two-tower bench step
STEPS = {
    "never8192": (8192, ["contrastive.fused_materialize_raw=never"]),
    "auto32768": (32768, []),
}
# the recompute pass's kernel in either tree, by its mangled name
KERNEL_KEYS = ("row_ce_grad_kernel", "sym_grad_kernel")
# profile_step with the step's batch swapped in for the model's default
# (works in a tree whose profile_step takes no batch)
_PROFILE = ("import sys\n"
            "from clip_dplm_tpu_torch.experiments import bench, profile_step\n"
            "m = bench.MODELS['two_tower']\n"
            "bench.MODELS['two_tower'] = (m[0], int(sys.argv[1]), *m[2:])\n"
            "profile_step.main(sys.argv[2:])\n")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", default="",
                    help=f"two-tower steps to time in turns, comma-separated: {sorted(STEPS)}")
    ap.add_argument("--profile", default="", choices=["", *sorted(STEPS)],
                    help="a two-tower step to profile in each tree")
    args = ap.parse_args(argv)
    unknown = [s for s in args.steps.split(",") if s and s not in STEPS]
    if unknown:
        ap.error(f"unknown steps {unknown}: choose from {sorted(STEPS)}")
    return args


def work(m: int, n: int, d: int = D):
    """(bytes, operations) one call must move and do: x (m, d) and y (n, d)
    in bf16, lse_row (m), lse_col (n) and the scale in f32 read; acc (m, d)
    and rowdot (m) f32 written; the raw tile and the contraction, 4·m·n·d."""
    return (m + n) * d * 2 + (m + n) * 4 + 4 + m * d * 4 + m * 4, 4.0 * m * n * d


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = getattr(lib, ENTRY)
    fn.argtypes = _build._SIGNATURES[ENTRY]
    fn.restype = ctypes.c_int
    return lib


def other_source(other: Path) -> Path:
    """The file of the other tree that holds its `sym_infonce_grad` entry:
    row_ce.cu from this design on, fused_infonce.cu before it."""
    csrc = other / "clip_dplm_tpu_torch" / "csrc"
    row_ce = csrc / "row_ce.cu"
    if row_ce.exists() and f"int {ENTRY}(" in row_ce.read_text():
        return row_ce
    return csrc / "fused_infonce.cu"


def build_other(other: Path) -> ctypes.CDLL:
    """The other checkout's source of the entry, alone, as a shared library."""
    src = other_source(other)
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(src.parent.glob("*.cu*"))))
    out = REPO / "build" / "sym_ab" / f"libsym_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        for key in KERNEL_KEYS:
            for entry in ptxas_summary(proc.stdout + proc.stderr, key):
                print(json.dumps({"ptxas": "other", "kernel": key, **entry}), flush=True)
    return _bind(ctypes.CDLL(str(out)))


def inputs(m: int, seed: int = 11):
    """Unit rows x, y (m, D) in bf16, x pulled towards y (aligned pairs, as
    a trained model's)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.nn.functional.normalize(torch.randn(m, D, generator=g, device="cuda"), dim=-1)
    y = torch.nn.functional.normalize(torch.randn(m, D, generator=g, device="cuda"), dim=-1)
    x = torch.nn.functional.normalize(x + y, dim=-1)
    return x.bfloat16(), y.bfloat16()


def _err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    scale = max(want.abs().max().item(), 1e-30)
    if not (torch.isfinite(got).all() and torch.allclose(got / scale, want / scale, **TOL)):
        raise RuntimeError(f"{what} disagrees with the plain version")
    return (got - want).abs().max().item() / scale


def kernel_turns(lib_this: ctypes.CDLL, lib_other: ctypes.CDLL, rounds: int) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    scale = torch.tensor([SCALE], device="cuda")
    for what, m in SHAPES:
        x, y = inputs(m)
        lse_row, lse_col = fi._plain_lse(x, y, scale)
        want = fi._plain_grad(x, y, scale, lse_row, lse_col)
        # the parent's kernel writes whole 32-row tiles: room for them
        out = {t: (torch.empty(-(-m // 64) * 64, D, device="cuda"), torch.empty(m, device="cuda"))
               for t in ("this", "other", "again")}

        def call(lib, tree):
            acc, rowdot = out[tree]
            rc = lib.sym_infonce_grad(x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                                      lse_row.data_ptr(), lse_col.data_ptr(), acc.data_ptr(),
                                      rowdot.data_ptr(), m, m, D, stream)
            if rc != 0:
                raise RuntimeError(f"{tree} {ENTRY} {what}: CUDA error {rc}")

        errs = {}
        calls = lib_this.row_ce_grad_calls(SYM_MODE)
        for tree, lib in (("this", lib_this), ("other", lib_other), ("again", lib_this)):
            call(lib, tree)
            torch.cuda.synchronize()
            if tree != "again":
                errs[tree] = max(_err(g, w, f"{tree} {ENTRY} {what}")
                                 for g, w in zip((out[tree][0][:m], out[tree][1]), want))
        equal = all(torch.equal(a[:m], b[:m]) for a, b in zip(out["this"], out["again"]))
        moved = lib_this.row_ce_grad_calls(SYM_MODE) - calls
        if not equal or moved != 2:
            raise RuntimeError(f"this {ENTRY} {what}: two launches equal {equal}, "
                               f"row_ce_grad_kernel symmetric calls {moved} (want 2)")
        del want
        fns = {tree: (lambda lib=lib, tree=tree: call(lib, tree))
               for tree, lib in (("this", lib_this), ("other", lib_other))}
        times = {"this": [], "other": []}
        for _ in range(rounds):
            for tree in ("other", "this", "this", "other"):
                times[tree].append(cuda_ms(fns[tree]))
        b_ms, b_by = bound(*work(m, m))
        print(json.dumps({
            "kernel": ENTRY, "shape": what, "m": m, "n": m, "d": D,
            "this_splits": fi._from_raw_splits(m, m, fi._sm_count(0)),
            "this_ms": times["this"], "other_ms": times["other"],
            "bound_ms": b_ms, "bound_by": b_by,
            "this_over_bound": min(times["this"]) / b_ms,
            "other_over_bound": min(times["other"]) / b_ms,
            "speedup": min(times["other"]) / min(times["this"]), "max_err": errs,
            "two_launches_equal": equal}), flush=True)
        del x, y, out
        torch.cuda.empty_cache()


def _run(tree: Path, args) -> str:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, *args], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} in {tree} failed:\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return proc.stdout


def _overrides(step: str):
    return [a for o in STEPS[step][1] for a in ("-o", o)]


def step_turns(other: Path, steps, rounds: int) -> None:
    """Each tree's two-tower bench step in processes of their own, in turns
    other, this, this, other, `rounds` times (one JSON line a step a
    round)."""
    for _ in range(rounds):
        for step in steps:
            times = {"this": [], "other": []}
            for tree in ("other", "this", "this", "other"):
                stdout = _run(REPO if tree == "this" else other,
                              ["-m", "clip_dplm_tpu_torch.experiments.bench", "--model",
                               "two_tower", "--batch", str(STEPS[step][0]), *_overrides(step)])
                times[tree].append(json.loads(stdout.strip().splitlines()[-1])["step_ms"])
            print(json.dumps({"bench": step, "this_step_ms": times["this"],
                              "other_step_ms": times["other"]}), flush=True)


def profile_step(other: Path, step: str) -> None:
    """Each tree's profile of the step in a process of its own: the device
    ms a step of its recompute-pass kernel, the busy time and the rest."""
    args = ["-c", _PROFILE, str(STEPS[step][0]), "--model", "two_tower", *_overrides(step),
            "--kernels", ",".join(KERNEL_KEYS)]
    for tree in ("other", "this"):
        lines = [json.loads(x) for x in _run(REPO if tree == "this" else other, args).splitlines()
                 if x.startswith("{")]
        grad = [x for x in lines if any(k in x.get("kernel", "") for k in KERNEL_KEYS)]
        print(json.dumps({
            "profile": step, "tree": tree,
            "grad_device_ms_per_step": sum(x["device_ms_per_step"] for x in grad),
            "grad_launches_per_step": sum(x["launches_per_step"] for x in grad),
            "kernels": {x["kernel"][:90]: x["device_ms_per_step"] for x in grad},
            "top": [x for x in lines[:-1] if "kernel" in x][:12],
            "summary": lines[-1]}), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("sym_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    other = args.other.resolve()
    lib_this = _bind(_build.LIBRARY.get())
    for entry in ptxas_summary(_build.LIBRARY.build_log, KERNEL_KEYS[0]):
        print(json.dumps({"ptxas": "this", "kernel": KERNEL_KEYS[0], **entry}), flush=True)
    lib_other = build_other(other)
    kernel_turns(lib_this, lib_other, args.rounds)
    if args.steps:
        step_turns(other, args.steps.split(","), args.rounds)
    if args.profile:
        profile_step(other, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
