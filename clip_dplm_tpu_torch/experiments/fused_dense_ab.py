"""The fused-Dense block's two row passes (the forward epilogue
`fused_dense_fwd_rows` and the backward row pass `fused_dense_bwd_rows`) of
this checkout against another checkout's, in turns on one card, with each
pass's bytes bound and this checkout's whole block beside them:

    python -m clip_dplm_tpu_torch.experiments.fused_dense_ab --other DIR [--rounds N]
        [--variant] [--define NAME=VALUE ...] [--steps MODEL,...] [--profile MODEL,...]

DIR is another checkout of the repository (for example a parent commit
unpacked with `git archive` into a directory that `.gitignore` lists), or a
directory under `build/` holding only `clip_dplm_tpu_torch/csrc/{
fused_dense.cu,common.cuh,dense_gemm.cuh,tma.cuh,wgmma.cuh}` (a variant of
the kernels). The other tree's `csrc/fused_dense.cu` is compiled alone with
nvcc into `build/fused_dense_ab/`; this checkout's comes from the package's
library; `--define NAME=VALUE` adds -DNAME=VALUE to the other tree's build
(`--other . --define FD_BWD_SPLIT=2`: this checkout's backward with every
row split over a cluster of two blocks, against the shipped shape rule).
Both trees' C entries are called through ctypes on the same inputs
at `chip_smoke.py`'s FD_GEOMETRIES (the two-tower step's four shapes at
B=8192, its head fc0 at B=1000, the flagship's three head shapes at
B=1024): the forward on u = bf16(x W^T) + b from this tree's GEMM, the
backward on the plain forward's residuals and a dy in the block's output
type (f32 for the act_ln tower final and the skip tail, bf16 for the
heads). A tree whose backward entry has no `fused_dense_bwd_work` (before
the one-launch design) is called the way its wrapper called it: two
launches into per-32-row column partials, summed by two torch reductions,
timed with them. Both are held to the plain versions (`_plain_rows_fwd`,
`_plain_bwd`; atol = rtol = 2e-2, gradients summed over the batch divided
by their largest entry first), this tree's two launches must agree byte
for byte, and both are timed in turns other, this, this, other, `--rounds`
times (with `--variant` the other tree is a variant that leaves out part of
the work, to see what holds the kernels, and is timed without the check).
The forward runs in place over its u buffer: every geometry's
rewrite (relu under act_ln) is idempotent, so the repeated calls see the
same input. At B=1000 and 1024 the inputs fit in the 50 MB L2 and the
repeated calls read them warm.

One JSON line a geometry and pass, with the bound: the bytes the row pass
must move (each input read once, each output written once; `work_fwd`,
`work_bwd`) over 3.35 TB/s; and this tree's whole block (GEMM, rows and
wrapper; the backward with the dx GEMM and cuBLAS's dW) timed the same
way. ptxas's registers and spills of both trees' row kernels are printed
first.

`--steps two_tower,rna_rbp` then runs each checkout's `experiments/bench.py
--model M` in processes of their own, in turns other, this, this, other,
`--rounds` times, and `--profile two_tower,rna_rbp` each checkout's
`experiments/profile_step.py --model M` in a process of its own for each
model (torch.profiler shows kernels only in a process's first session),
printing the device ms and launches a step of its row kernels beside the
step's busy time and launches. Needs a CUDA device and nvcc.
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
from clip_dplm_tpu_torch.ops import fused_dense as fd

REPO = Path(__file__).resolve().parents[2]
HBM_BYTES_PER_S = 3.35e12
TOL = dict(atol=2e-2, rtol=2e-2)
SEED = 777
# chip_smoke.py's FD_GEOMETRIES: what, B, K, N, order, act, dropout, skip tail
GEOMETRIES = (
    ("tower final", 8192, 1024, 1024, "act_ln", "relu", 0.0, False),
    ("head fc0", 8192, 1024, 2048, "ln_act", "gelu", 0.1, False),
    ("head fc1", 8192, 2048, 2048, "ln_act", "gelu", 0.1, False),
    ("head fc_out", 8192, 2048, 512, "ln_act", "none", 0.0, True),
    ("head fc0 ragged", 1000, 1024, 2048, "ln_act", "gelu", 0.1, False),
    ("flagship fc0", 1024, 512, 2048, "ln_act", "gelu", 0.1, False),
    ("flagship fc1", 1024, 2048, 2048, "ln_act", "gelu", 0.1, False),
    ("flagship fc_out", 1024, 2048, 512, "ln_act", "none", 0.0, True),
)
ENTRIES = ("fused_dense_fwd_rows", "fused_dense_bwd_rows")
# the row kernels of either tree, as ptxas and torch.profiler name them
ROW_KEYS = ("fwd_rows_kernel", "bwd_rows_kernel", "bwd_stats_kernel", "bwd_cols_kernel")
OLD_BWD_ROWS = 32  # rows a column partial of the two-launch backward


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variant", action="store_true",
                    help="the other tree leaves out part of the work: time it unchecked")
    ap.add_argument("--define", action="append", default=[], metavar="NAME=VALUE",
                    help="a macro for the other tree's build (-DNAME=VALUE)")
    ap.add_argument("--steps", default="", help="bench models to time in turns, comma-separated")
    ap.add_argument("--profile", default="",
                    help="bench models to profile in each tree, comma-separated")
    return ap.parse_args(argv)


def spec_of(geometry) -> fd._Spec:
    """The block's static description at a geometry (the smoke's: dropout
    seed 777, f32 output for act_ln and the skip tail, no L2 output)."""
    _, _, _, _, order, act, rate, skip = geometry
    out = torch.float32 if (skip or order == "act_ln") else torch.bfloat16
    return fd._Spec(order, act, rate, SEED, torch.bfloat16, out, False)


def rewrites_s(spec: fd._Spec) -> bool:
    """The forward writes s over u: an act_ln activation whose output is
    the saved LN input."""
    return not spec.ln_act and spec.act != "none" and not spec.saves_pre


def work_fwd(B: int, N: int, spec: fd._Spec, skip: bool) -> int:
    """Bytes the forward row pass must move: u (bf16) read; y written in
    the output type; s written where act_ln rewrites it; the skip rows and
    the layer scale read with the skip tail; mean and rstd written; gamma
    and beta (f32) read."""
    y = spec.out_dtype.itemsize
    nbytes = B * N * (2 + y) + B * 8 + N * 8
    if rewrites_s(spec):
        nbytes += B * N * 2
    if skip:
        nbytes += B * N * 2 + 4
    return nbytes


def work_bwd(B: int, N: int, dy_bytes: int, skip: bool, l2: bool) -> int:
    """Bytes the backward row pass must move: the saved rows (bf16), dy (f32
    or bf16), mean, rstd, gamma and beta read, du (bf16) written, dgamma,
    dbeta and db (f32) written; with the skip tail the layer scale read and
    dls written; with an L2 output the skip rows read and dskip (bf16)
    written."""
    nbytes = B * N * (2 + dy_bytes + 2) + B * 8 + N * 8 + N * 12
    if skip:
        nbytes += 8
    if l2:
        nbytes += B * N * 4
    return nbytes


def bound(nbytes: float):
    """(bound_ms, "bytes"): a row pass is bound by device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def ptxas_rows(log: str, keys=ROW_KEYS):
    """{"kernel", "instance", "registers", "stack_frame", "spill_stores",
    "spill_loads"} of each row kernel in nvcc's -Xptxas=-v report, template
    arguments (if any) as <a, b>."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        found = re.search(r"Compiling entry function '([^']+)'", line)
        key = next((k for k in keys if found and k in found.group(1)), None)
        if key is None:
            continue
        args = re.search(key + r"I((?:L[ib]\d+E)+)E", found.group(1))
        near = " ".join(lines[i:i + 4])
        regs = re.search(r"Used (\d+) registers", near)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", near)
        yield {"kernel": key,
               "instance": "<" + ", ".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
               if args else "",
               "registers": int(regs.group(1)) if regs else None,
               **{k: int(spill.group(j + 1)) if spill else None
                  for j, k in enumerate(("stack_frame", "spill_stores", "spill_loads"))}}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    if hasattr(lib, "fused_dense_bwd_work"):
        lib.fused_dense_bwd_work.argtypes = _build._SIGNATURES["fused_dense_bwd_work"]
        lib.fused_dense_bwd_work.restype = ctypes.c_int
    return lib


def build_other(other: Path, defines=()) -> ctypes.CDLL:
    """The other checkout's fused_dense.cu, alone, as a shared library, with
    -D of each NAME=VALUE in `defines`."""
    csrc = other / "clip_dplm_tpu_torch" / "csrc"
    flags = [f"-D{d}" for d in defines]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cu*")))
                            + " ".join(flags).encode())
    out = REPO / "build" / "fused_dense_ab" / f"libfd_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(out),
               str(csrc / "fused_dense.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        for entry in ptxas_rows(proc.stdout + proc.stderr):
            print(json.dumps({"ptxas": "other", **entry}), flush=True)
    return _bind(ctypes.CDLL(str(out)))


def inputs(geometry, seed: int = 3):
    """x, W, b, gamma, beta, (skip, layer scale) and dy as the smoke makes
    them, and u = bf16(x W^T) + b from this tree's GEMM."""
    _, B, K, N, _, _, _, skip = geometry
    spec = spec_of(geometry)
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    x, w = rnd(B, K).bfloat16(), rnd(N, K) / K ** 0.5
    b, gm, bt = rnd(N) * 0.1, 1.0 + 0.1 * rnd(N), rnd(N) * 0.1
    sk, ls = (rnd(B, N).bfloat16(), torch.tensor([0.3], device="cuda")) if skip else (None, None)
    dy = rnd(B, N).to(spec.out_dtype)
    u = fd._gemm(x, w.bfloat16(), b.bfloat16(), N, b_row=False)
    return dict(x=x, w=w, b=b, gm=gm, bt=bt, skip=sk, ls=ls, dy=dy, u=u)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scalars(spec: fd._Spec):
    return (int(spec.ln_act), fd._ACT_CODE[spec.act], int(spec.saves_pre), spec.seed,
            fd.dropout_threshold(spec.rate) if spec.rate > 0.0 else 0, fd.keep_prob(spec.rate))


def fwd_call(lib, spec, a, s_buf):
    """One call of a tree's forward row entry over s_buf (in place): y,
    mean, rstd."""
    B, N = s_buf.shape
    y = torch.empty((B, N), dtype=spec.out_dtype, device="cuda")
    mean, rstd = (torch.empty(B, device="cuda") for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.fused_dense_fwd_rows(s_buf.data_ptr(), y.data_ptr(), mean.data_ptr(),
                                  rstd.data_ptr(), a["gm"].data_ptr(), a["bt"].data_ptr(),
                                  _ptr(a["skip"]), _ptr(a["ls"]), B, N, *_scalars(spec),
                                  int(spec.l2), int(spec.out_dtype == torch.float32), stream)
    if rc != 0:
        raise RuntimeError(f"fused_dense_fwd_rows: CUDA error {rc}")
    return y, mean, rstd


def bwd_call(lib, spec, a, saved, mean, rstd):
    """One call of a tree's backward row entry: du, dgamma, dbeta, db and
    dls (or None). A tree from before the one-launch design writes column
    partials, summed here by torch as its wrapper summed them."""
    B, N = saved.shape
    dy, ls = a["dy"], a["ls"]
    du = torch.empty((B, N), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    tail = (B, N, *_scalars(spec), int(spec.l2), int(dy.dtype == torch.float32), stream)
    head = (dy.data_ptr(), saved.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            a["gm"].data_ptr(), a["bt"].data_ptr(), None, _ptr(ls))
    if hasattr(lib, "fused_dense_bwd_work"):
        sums = torch.empty((3, N), device="cuda")
        dls = torch.empty(1, device="cuda") if ls is not None else None
        work = torch.empty(lib.fused_dense_bwd_work(N), dtype=torch.uint8, device="cuda")
        rc = lib.fused_dense_bwd_rows(*head, du.data_ptr(), None, sums[0].data_ptr(),
                                      sums[1].data_ptr(), sums[2].data_ptr(), _ptr(dls),
                                      work.data_ptr(), *tail)
        dg, dbeta, db = sums
    else:
        nb = -(-B // OLD_BWD_ROWS)
        parts = torch.empty((3, nb, N), device="cuda")
        stats = torch.empty((B, 8), device="cuda")
        dls_part = torch.empty(nb, device="cuda") if ls is not None else None
        rc = lib.fused_dense_bwd_rows(*head, stats.data_ptr(), du.data_ptr(), None,
                                      parts[0].data_ptr(), parts[1].data_ptr(),
                                      parts[2].data_ptr(), _ptr(dls_part), *tail)
        dg, dbeta, db = parts.sum(dim=1)
        dls = None if ls is None else dls_part.sum().reshape(1)
    if rc != 0:
        raise RuntimeError(f"fused_dense_bwd_rows: CUDA error {rc}")
    return du, dg, dbeta, db, dls


def _err(got, want, what: str, raw: bool) -> float:
    got, want = got.float(), want.float()
    scale = 1.0 if raw else max(want.abs().max().item(), 1e-30)
    if not (torch.isfinite(got).all() and torch.allclose(got / scale, want / scale, **TOL)):
        raise RuntimeError(f"{what} disagrees with the plain version")
    return (got - want).abs().max().item() / scale


def _turns(fns, rounds: int):
    times = {"this": [], "other": []}
    for _ in range(rounds):
        for tree in ("other", "this", "this", "other"):
            times[tree].append(cuda_ms(fns[tree]))
    return times


def _line(entry, geometry, times, nbytes, errs, **extra):
    what, B, K, N = geometry[:4]
    bound_ms, by = bound(nbytes)
    return {"kernel": entry, "shape": what, "B": B, "K": K, "N": N,
            "this_ms": times["this"], "other_ms": times["other"], "bound_ms": bound_ms,
            "bound_by": by, "this_over_bound": min(times["this"]) / bound_ms,
            "other_over_bound": min(times["other"]) / bound_ms,
            "speedup": min(times["other"]) / min(times["this"]), "max_err": errs, **extra}


def block_ms(spec, a, geometry):
    """This tree's whole block, forward and backward, on the card (the
    smoke's timing): (forward ms, backward ms)."""
    kw = dict(order=spec.order, act=spec.act, dropout_rate=spec.rate, dropout_seed=spec.seed,
              deterministic=spec.rate == 0.0, out_dtype=spec.out_dtype)
    if geometry[-1]:
        kw.update(skip=a["skip"], layer_scale=a["ls"])
    args = (a["x"], a["w"], a["b"], a["gm"], a["bt"])
    with torch.no_grad():
        fwd = min(cuda_ms(lambda: fd.fused_dense_norm_act(*args, **kw)) for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in args]
    y = fd.fused_dense_norm_act(*leaves, **kw)
    bwd = min(cuda_ms(lambda: y.backward(a["dy"], retain_graph=True)) for _ in range(2))
    return fwd, bwd


def kernel_turns(lib_this, lib_other, rounds: int, variant: bool = False) -> None:
    for geometry in GEOMETRIES:
        what, B, K, N, _, _, _, skip = geometry
        spec = spec_of(geometry)
        a = inputs(geometry)
        y_p, saved_p, mean_p, rstd_p = fd._plain_rows_fwd(spec, a["u"], a["gm"], a["bt"],
                                                          a["skip"], a["ls"])
        # forward: each tree on its own copy of u, held to the plain rows
        bufs = {t: a["u"].clone() for t in ("this", "other")}
        libs = {"this": lib_this, "other": lib_other}
        errs, outs = {}, {}
        checked = ("this",) if variant else ("this", "other")
        for tree in checked:
            outs[tree] = fwd_call(libs[tree], spec, a, bufs[tree])
            torch.cuda.synchronize()
            errs[tree] = max(_err(outs[tree][0], y_p, f"{tree} forward {what}", True),
                             _err(bufs[tree], saved_p, f"{tree} saved {what}", True),
                             _err(outs[tree][1], mean_p, f"{tree} mean {what}", True),
                             _err(outs[tree][2], rstd_p, f"{tree} rstd {what}", False))
            if spec.rate and not torch.equal(outs[tree][0] == 0, y_p == 0):
                raise RuntimeError(f"{tree} forward {what}: dropout mask differs")
        again = fwd_call(lib_this, spec, a, bufs["this"])
        equal_fwd = all(torch.equal(p, q) for p, q in zip(outs["this"], again))
        times = _turns({t: (lambda t=t: fwd_call(libs[t], spec, a, bufs[t]))
                        for t in libs}, rounds)
        fwd_block, bwd_block = block_ms(spec, a, geometry)
        print(json.dumps(_line(ENTRIES[0], geometry, times, work_fwd(B, N, spec, skip), errs,
                               this_equal_twice=equal_fwd, block_ms=fwd_block,
                               other_is_variant=variant)), flush=True)
        # backward: both trees on the plain forward's residuals
        want = fd._plain_bwd(spec, a["dy"], saved_p, mean_p, rstd_p, a["gm"], a["bt"], None,
                             a["ls"])
        want = list(want[:4]) + ([want[4].reshape(1)] if skip else [])
        for tree in checked:
            got = bwd_call(libs[tree], spec, a, saved_p, mean_p, rstd_p)
            torch.cuda.synchronize()
            errs[tree] = max(_err(g, w, f"{tree} backward {what} #{i}", i == 0)
                             for i, (g, w) in enumerate(zip(got, want)))
            outs[tree] = got
        again = bwd_call(lib_this, spec, a, saved_p, mean_p, rstd_p)
        equal_bwd = all(torch.equal(p, q) for p, q in zip(outs["this"], again)
                        if p is not None)
        times = _turns({t: (lambda t=t: bwd_call(libs[t], spec, a, saved_p, mean_p, rstd_p))
                        for t in libs}, rounds)
        nbytes = work_bwd(B, N, a["dy"].element_size(), skip, spec.l2)
        print(json.dumps(_line(ENTRIES[1], geometry, times, nbytes, errs,
                               this_equal_twice=equal_bwd, block_ms=bwd_block,
                               other_is_variant=variant)), flush=True)
        if not (equal_fwd and equal_bwd):
            raise RuntimeError(f"{what}: two launches of this tree's row passes differ")


def step_turns(other: Path, models, rounds: int) -> None:
    """Each tree's bench step in processes of their own, in turns other,
    this, this, other, `rounds` times (one JSON line a model a round)."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import step_turns as turns

    for _ in range(rounds):
        turns(other, models)


def profile_rows(other: Path, model: str) -> None:
    """Each tree's profile_step, in a process of its own: the device ms and
    launches a step of its row kernels, and the step's busy time and
    launches."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import _run

    for tree in ("other", "this"):
        lines = [json.loads(x) for x in _run(REPO if tree == "this" else other, "profile_step",
                                             ["--model", model, "--kernels",
                                              ",".join(ROW_KEYS)]).splitlines()
                 if x.startswith("{")]
        rows = [x for x in lines if any(k in x.get("kernel", "") for k in ROW_KEYS)]
        print(json.dumps({
            "profile": model, "tree": tree,
            "rows_device_ms_per_step": sum(x["device_ms_per_step"] for x in rows),
            "rows_launches_per_step": sum(x["launches_per_step"] for x in rows),
            "kernels": {x["kernel"][:90]: x["device_ms_per_step"] for x in rows},
            "summary": lines[-1]}), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_dense_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    lib_this = _bind(_build.LIBRARY.get())
    for entry in ptxas_rows(_build.LIBRARY.build_log):
        print(json.dumps({"ptxas": "this", **entry}), flush=True)
    lib_other = build_other(args.other.resolve(), args.define)
    kernel_turns(lib_this, lib_other, args.rounds, args.variant)
    if args.steps:
        step_turns(args.other.resolve(), args.steps.split(","), args.rounds)
    for model in filter(None, args.profile.split(",")):
        profile_rows(args.other.resolve(), model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
