"""The InfoNCE forwards' logsumexp (the row-CE's `row_ce_lse`, the symmetric
loss's `sym_infonce_lse` and `sym_infonce_lse_save`, each with the combine of
its partials) of this checkout against another checkout's, in turns on one
card, with the bound beside them:

    python -m clip_dplm_tpu_torch.experiments.lse_ab --other DIR [--rounds N]
        [--steps MODEL,...] [--profile MODEL,...]

DIR is another checkout of the repository (for example a parent commit
unpacked with `git archive` into a directory that `.gitignore` lists), or a
directory under `build/` holding only `clip_dplm_tpu_torch/csrc/{lse_walk.cu,
common.cuh,tma.cuh,wgmma.cuh}` (a variant of the walk). A tree with
`csrc/lse_walk.cu` is called through its walk and combine entries; a tree
from before it (the WMMA kernels, one block a 32 rows) through `row_ce.cu`'s
and `fused_infonce.cu`'s entries, its column partials combined in torch as
that tree's wrapper did. The other tree's sources are compiled alone with
nvcc into `build/lse_ab/`; this checkout's come from the package's library.
Both are called through ctypes on the same inputs and held to the plain
versions (`_plain_row_lse`, `_plain_lse_save`: atol = rtol = 2e-2; the int16
raw within 1), at `chip_smoke.py`'s phase-10 shapes (a -> [b; cache] with
n_valid = 13192, b -> a, ragged 1000 x 1777), phase 11's saving forward at
B = 8192, 4096, 1000, 256, 200 and phase 6's non-saving one at B = 8192 and
1000, d = 512, and timed in turns other, this, this, other, `--rounds`
times. Each time covers the whole lse (walk and combine); this tree's walk
and combine are also timed apart. One JSON line a shape, with the bound (the
larger of the bytes the call must move over 3.35 TB/s and its operations
over 989 TFLOP/s) and each time over it. ptxas's registers and spills of
both trees' lse kernels are printed first.

`--steps two_tower_cached,two_tower,tf_clip` then runs each checkout's
`experiments/bench.py --model M` in processes of their own, in turns other,
this, this, other, `--rounds` times, and `--profile two_tower_cached,tf_clip`
each checkout's `experiments/profile_step.py --model MODEL` in a process of
its own for each model (torch.profiler shows kernels only in a process's
first session), printing the device ms a step of its lse kernels. Needs a CUDA device and nvcc.
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
from clip_dplm_tpu_torch.experiments.row_ce_ab import (
    SHAPES as ROW_CE_SHAPES,
    bound,
    inputs,
    ptxas_summary,
)
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import fused_infonce as fi

REPO = Path(__file__).resolve().parents[2]
TOL = dict(atol=2e-2, rtol=2e-2)
D = 512
SCALE = 14.2857
# (what, B, saves the raw): phase 11's saving forward, phase 6's non-saving one
SYM_SHAPES = (("two-tower", 8192, True), ("tf_clip pair", 4096, True), ("ragged", 1000, True),
              ("train CLI", 256, True), ("ragged one cluster", 200, True),
              ("two-tower", 8192, False), ("ragged", 1000, False))
WALK_KEYS = ("lse_walk_kernel", "lse_combine_kernel")
OLD_KEYS = ("row_ce_lse_kernel", "sym_lse_kernel")
# the lse kernels of either tree, as torch.profiler names them
PROFILE_KEYS = WALK_KEYS + OLD_KEYS


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", default="", help="bench models to time in turns, comma-separated")
    ap.add_argument("--profile", default="",
                    help="bench models to profile in each tree, comma-separated")
    return ap.parse_args(argv)


def work(kind: str, m: int, n: int, d: int = D):
    """(bytes, operations) the call must move and do: x and the walked (valid)
    rows of y in bf16, the scale (and n_valid) in; the lse out (the column lse
    too for the symmetric loss, the int16 raw too when it saves); the raw
    product, 2·m·n·d (n the valid columns)."""
    nbytes = (m + n) * d * 2 + 4 + m * 4
    if kind == "row_ce":
        return nbytes + 4, 2.0 * m * n * d
    nbytes += n * 4 + (m * n * 2 if kind == "save" else 0)
    return nbytes, 2.0 * m * n * d


class Tree:
    """One tree's lse entries through ctypes: `walk` (lse_walk.cu: the walk
    and the combine kernel) or the WMMA entries of a tree from before it."""

    def __init__(self, lib: ctypes.CDLL, walk: bool):
        self.lib, self.walk = lib, walk
        names = (("row_ce_lse", "sym_infonce_lse", "sym_infonce_lse_save", "lse_combine")
                 if walk else ("row_ce_lse", "sym_infonce_lse", "sym_infonce_lse_save"))
        P, I = ctypes.c_void_p, ctypes.c_int  # noqa: N806
        old = {"row_ce_lse": [P, P, P, P, P, I, I, I, P],
               "sym_infonce_lse": [P, P, P, P, P, P, I, I, I, P],
               "sym_infonce_lse_save": [P, P, P, P, P, P, P, I, I, I, I, P]}
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = _build._SIGNATURES[name] if walk else old[name]
            fn.restype = ctypes.c_int

    def _check(self, rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    def combine(self, part, nsplit, m, groups, n, stream):
        row = torch.empty(m, device="cuda")
        col = torch.empty(n, device="cuda") if n else None
        self._check(self.lib.lse_combine(part.data_ptr(), nsplit, m, groups, n, row.data_ptr(),
                                         None if col is None else col.data_ptr(), stream),
                    "lse_combine")
        return row, col

    def row_ce(self, x, y, scale, nvt, walk_only=False):
        m, n = x.shape[0], y.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        if not self.walk:
            lse = torch.empty(m, device="cuda")
            self._check(self.lib.row_ce_lse(x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                                            nvt.data_ptr(), lse.data_ptr(), m, n, D, stream),
                        "row_ce_lse")
            return lse
        nsplit = fi._walk_splits(m, n, fi._sm_count(x.device.index))
        part = torch.empty(2 * nsplit * m, device="cuda")
        self._check(self.lib.row_ce_lse(x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                                        nvt.data_ptr(), part.data_ptr(), m, n, D, nsplit,
                                        stream), "row_ce_lse")
        return part if walk_only else self.combine(part, nsplit, m, 0, 0, stream)[0]

    def sym(self, x, y, scale, save, walk_only=False):
        m, n = x.shape[0], y.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        raw_q = (torch.empty((m, fi._raw_pitch(n)), dtype=torch.int16, device="cuda")
                 if save else None)
        q = (raw_q.data_ptr(), raw_q.shape[1]) if save else ()
        name = "sym_infonce_lse_save" if save else "sym_infonce_lse"
        if not self.walk:
            row = torch.empty(m, device="cuda")
            part = torch.empty((2, -(-m // 32), n), device="cuda")
            self._check(getattr(self.lib, name)(x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                                                row.data_ptr(), part[0].data_ptr(),
                                                part[1].data_ptr(), *q, m, n, D, stream), name)
            col = torch.logsumexp(part[0] + torch.log(torch.clamp(part[1], min=1e-30)), dim=0)
        else:
            nsplit = fi._walk_splits(m, n, fi._sm_count(x.device.index))
            groups = fi._walk_groups(m)
            part = torch.empty(2 * nsplit * m + 2 * groups * n, device="cuda")
            self._check(getattr(self.lib, name)(x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                                                part.data_ptr(), *q, m, n, D, nsplit, stream),
                        name)
            if walk_only:
                return part
            row, col = self.combine(part, nsplit, m, groups, n, stream)
        return (row, col, raw_q[:, :n]) if save else (row, col)


def _compile(sources, out: Path) -> None:
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for key in WALK_KEYS + OLD_KEYS:
        for entry in ptxas_summary(proc.stdout + proc.stderr, key):
            print(json.dumps({"ptxas": "other", "kernel": key, **entry}), flush=True)


def build_other(other: Path) -> Tree:
    """The other checkout's lse sources, alone, as a shared library: its
    lse_walk.cu, or row_ce.cu and fused_infonce.cu from before it."""
    csrc = other / "clip_dplm_tpu_torch" / "csrc"
    walk = (csrc / "lse_walk.cu").exists()
    sources = [csrc / "lse_walk.cu"] if walk else [csrc / "row_ce.cu", csrc / "fused_infonce.cu"]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cu*"))))
    out = REPO / "build" / "lse_ab" / f"liblse_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        _compile(sources, out)
    return Tree(ctypes.CDLL(str(out)), walk)


def _err(got, want, what: str) -> float:
    if not (torch.isfinite(got).all() and torch.allclose(got, want, **TOL)):
        raise RuntimeError(f"{what} disagrees with the plain version")
    return (got - want).abs().max().item()


def _held(out, want, what: str) -> float:
    """Max abs error of the lse against the plain version's (the raw within
    1 of it where saved)."""
    err = max(_err(a, b, f"{what} lse") for a, b in zip(out[:2], want[:2]))
    if len(out) == 3:
        dq = (out[2].int() - want[2].int()).abs().max().item()
        if out[2].shape != want[2].shape or dq > 1:
            raise RuntimeError(f"{what}: raw_q off by {dq} (bound 1)")
    return err


def _turns(fns, rounds: int):
    times = {"this": [], "other": []}
    for _ in range(rounds):
        for tree in ("other", "this", "this", "other"):
            times[tree].append(cuda_ms(fns[tree]))
    return times


def _line(kind, what, m, n, valid, times, walk_ms, combine_ms, errs):
    bound_ms, bound_by = bound(*work(kind, m, valid))
    return json.dumps({
        "kernel": {"row_ce": "row_ce_lse", "save": "sym_infonce_lse_save",
                   "lse": "sym_infonce_lse"}[kind], "shape": what, "m": m, "n": n,
        "n_valid": valid, "d": D, "this_ms": times["this"], "other_ms": times["other"],
        "this_walk_ms": walk_ms, "this_combine_ms": combine_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "this_over_bound": min(times["this"]) / bound_ms,
        "other_over_bound": min(times["other"]) / bound_ms,
        "speedup": min(times["other"]) / min(times["this"]), "max_err": errs})


def kernel_turns(this: Tree, other: Tree, rounds: int) -> None:
    scale = torch.tensor([SCALE], device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for what, m, n, nv, _ in ROW_CE_SHAPES:
        x, y = inputs(m, n)
        nvt = torch.tensor([nv], dtype=torch.int32, device="cuda")
        want = fi._plain_row_lse(x, y, scale, nvt)
        errs = {name: _err(tree.row_ce(x, y, scale, nvt), want, f"{name} row_ce_lse {what}")
                for name, tree in (("this", this), ("other", other))}
        times = _turns({"this": lambda: this.row_ce(x, y, scale, nvt),
                        "other": lambda: other.row_ce(x, y, scale, nvt)}, rounds)
        part = this.row_ce(x, y, scale, nvt, walk_only=True)
        nsplit = part.numel() // (2 * m)
        walk_ms = cuda_ms(lambda: this.row_ce(x, y, scale, nvt, walk_only=True))
        combine_ms = cuda_ms(lambda: this.combine(part, nsplit, m, 0, 0, stream))
        print(_line("row_ce", what, m, n, nv, times, walk_ms, combine_ms, errs), flush=True)
    for what, B, save in SYM_SHAPES:
        x, y = inputs(B, B)
        want = (fi._plain_lse_save if save else fi._plain_lse)(x, y, scale)
        errs = {name: _held(tree.sym(x, y, scale, save), want, f"{name} {what} B={B}")
                for name, tree in (("this", this), ("other", other))}
        times = _turns({"this": lambda: this.sym(x, y, scale, save),
                        "other": lambda: other.sym(x, y, scale, save)}, rounds)
        part = this.sym(x, y, scale, save, walk_only=True)
        nsplit = fi._walk_splits(B, B, fi._sm_count(x.device.index))
        groups = fi._walk_groups(B)
        walk_ms = cuda_ms(lambda: this.sym(x, y, scale, save, walk_only=True))
        combine_ms = cuda_ms(lambda: this.combine(part, nsplit, B, groups, B, stream))
        print(_line("save" if save else "lse", what, B, B, B, times, walk_ms, combine_ms, errs),
              flush=True)


def step_turns(other: Path, models, rounds: int) -> None:
    """Each tree's bench step in processes of their own, in turns other,
    this, this, other, `rounds` times (one JSON line a model a round): the
    host moves these steps by more than the kernels do."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import step_turns as turns

    for _ in range(rounds):
        turns(other, models)


def profile_lse(other: Path, model: str) -> None:
    """Each tree's profile_step, in a process of its own: the device ms a
    step of its lse kernels (the walk and the combine, or the WMMA lse)."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import _run

    for tree in ("other", "this"):
        # this tree's walk and combine are listed past the profile's top 25
        args = ["--model", model] + (["--kernels", ",".join(WALK_KEYS)] if tree == "this" else [])
        lines = [json.loads(x) for x in _run(REPO if tree == "this" else other, "profile_step",
                                             args).splitlines() if x.startswith("{")]
        lse = [x for x in lines if any(k in x.get("kernel", "") for k in PROFILE_KEYS)]
        print(json.dumps({
            "profile": model, "tree": tree,
            "lse_device_ms_per_step": sum(x["device_ms_per_step"] for x in lse),
            "lse_launches_per_step": sum(x["launches_per_step"] for x in lse),
            "kernels": {x["kernel"][:90]: x["device_ms_per_step"] for x in lse},
            "summary": lines[-1]}), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("lse_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    this = Tree(_build.LIBRARY.get(), walk=True)
    for key in WALK_KEYS:
        for entry in ptxas_summary(_build.LIBRARY.build_log, key):
            print(json.dumps({"ptxas": "this", "kernel": key, **entry}), flush=True)
    other = build_other(args.other.resolve())
    calls = [this.lib.lse_walk_calls(i) for i in range(3)]
    kernel_turns(this, other, args.rounds)
    print(json.dumps({"this_lse_walk_calls": {
        k: this.lib.lse_walk_calls(i) - calls[i]
        for i, k in enumerate(("row_ce_lse", "sym_infonce_lse", "sym_infonce_lse_save"))}}))
    if args.steps:
        step_turns(args.other.resolve(), args.steps.split(","), args.rounds)
    for model in filter(None, args.profile.split(",")):
        profile_lse(args.other.resolve(), model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
