"""The package's bf16 GEMM (csrc/dense_gemm.cuh) of this checkout against
another checkout's, in turns on one card, with cuBLAS and the bound beside
them:

    python -m clip_dplm_tpu_torch.experiments.gemm_ab --other DIR [--rounds N]
        [--steps MODEL,...] [--profile MODEL]

DIR is another checkout of the repository (for example a parent commit
unpacked with `git archive` into a directory that `.gitignore` lists). Its
`clip_dplm_tpu_torch/csrc/fused_dense.cu` (with its `dense_gemm.cuh`) and
`short_attention.cu`, the two files whose C entries launch the GEMM, are
compiled with nvcc (one process each, started together) into one shared
library under `build/gemm_ab/`. Both checkouts' entries are called through
ctypes on the same inputs: `fused_dense_gemm` (x·W^T + b, the bias added
after a rounding, B K-major; dx = du·W, B MN-major, no bias) and
`short_attention_out_proj` (o·Wo^T + bo, one rounding). Both are held
against the plain product (f32, then rounded as the epilogue says; atol =
rtol = 2e-2) and timed in turns other, this, this, other, `--rounds` times,
at:

- the four B=8192 shapes of `chip_smoke.py`'s FD_GEOMETRIES in both
  directions (1024->1024, 1024->2048, 2048->2048, 2048->512);
- the out-projection at the DPLM sampler's M=4096 and DPLM training's
  M=32768 (N=K=640), the flagship's M=131072 (N=K=512; bound by its bytes)
  and tf_clip's tiny path M=40960 (N=K=512).

One JSON line per shape, with cuBLAS's time (`F.linear` or `torch.mm`, timed
only) and the bound: the larger of the bytes the call must move (A, B and
the bias read once, C written once) over 3.35 TB/s and its operations over
989 TFLOP/s.

`--steps dplm,rna_rbp` then runs each checkout's `experiments/bench.py
--model M` in a process of its own, in turns other, this, this, other, and
`--profile dplm` each checkout's `experiments/profile_step.py --model M`
once, printing the device ms a step of its GEMM kernel. Needs a CUDA device
and nvcc.
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

from clip_dplm_tpu_torch.experiments.flash_ab import cuda_ms, ptxas_lines
from clip_dplm_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[2]
PEAK_BF16 = 989e12  # H100 SXM dense bf16
HBM_BYTES_PER_S = 3.35e12
TOL = dict(atol=2e-2, rtol=2e-2)
ENTRIES = ("fused_dense_gemm", "short_attention_out_proj")
SOURCES = ("fused_dense.cu", "short_attention.cu")
GEMM_KEY = "dense_gemm_kernel"  # in the kernel's mangled name
# name, M, Kr, Nc, B row-major (MN-major), epilogue ("round": bf16(bf16(acc) +
# b), "once": bf16(acc + b), "none": bf16(acc))
SHAPES = tuple(
    case for K, N in ((1024, 1024), (1024, 2048), (2048, 2048), (2048, 512))
    for case in ((f"x W^T + b {K}->{N}", 8192, K, N, False, "round"),
                 (f"dx = du W {N}->{K}", 8192, N, K, True, "none"))
) + (
    ("out-projection, sampler", 4096, 640, 640, False, "once"),
    ("out-projection, DPLM training", 32768, 640, 640, False, "once"),
    ("out-projection, flagship", 131072, 512, 512, False, "once"),
    ("out-projection, tf_clip tiny path", 40960, 512, 512, False, "once"),
)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def build_other(other: Path) -> ctypes.CDLL:
    """The other checkout's two GEMM-launching sources as one shared
    library."""
    csrc = other / "clip_dplm_tpu_torch" / "csrc"
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cu*"))))
    tag = digest.hexdigest()[:16]
    out = REPO / "build" / "gemm_ab" / f"libgemm_{tag}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc = _build._nvcc()
        objs = [out.parent / f"{Path(s).stem}.{tag}.{os.getpid()}.o" for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(csrc / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [(p.communicate()[0], p.returncode) for p in procs]
        if any(rc != 0 for _, rc in logs):
            raise RuntimeError("nvcc failed:\n" + "".join(log for log, _ in logs))
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        for o in objs:
            o.unlink(missing_ok=True)
        for line in ptxas_lines("".join(log for log, _ in logs), GEMM_KEY):
            print("other ptxas:", line)
    return _bind(ctypes.CDLL(str(out)))


def plain(a, b, bias, b_row, epilogue):
    """The product in f32, rounded as the epilogue says."""
    acc = a.float() @ (b.float() if b_row else b.float().t())
    if epilogue == "round":
        return (acc.bfloat16().float() + bias.float()).bfloat16()
    if epilogue == "once":
        return (acc + bias.float()).bfloat16()
    return acc.bfloat16()


def kernel_turns(lib_this: ctypes.CDLL, lib_other: ctypes.CDLL, rounds: int) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    for name, M, Kr, Nc, b_row, epilogue in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        a = torch.randn(M, Kr, generator=g, device="cuda").bfloat16()
        b = (torch.randn(*((Kr, Nc) if b_row else (Nc, Kr)), generator=g, device="cuda")
             / Kr ** 0.5).bfloat16()
        bias = None if epilogue == "none" else torch.randn(Nc, generator=g,
                                                           device="cuda").bfloat16()
        out = {t: torch.empty(M, Nc, dtype=torch.bfloat16, device="cuda")
               for t in ("this", "other")}
        bias_p = None if bias is None else bias.data_ptr()

        def call(lib, tree):
            c = out[tree].data_ptr()
            if epilogue == "once":
                rc = lib.short_attention_out_proj(a.data_ptr(), b.data_ptr(), bias_p, c, M, Nc,
                                                  Kr, stream)
            else:
                rc = lib.fused_dense_gemm(a.data_ptr(), b.data_ptr(), bias_p, c, M, Nc, Kr,
                                          int(b_row), stream)
            if rc != 0:
                raise RuntimeError(f"{tree} {name}: CUDA error {rc}")

        fns = {tree: (lambda lib=lib, tree=tree: call(lib, tree))
               for tree, lib in (("this", lib_this), ("other", lib_other))}
        want = plain(a, b, bias, b_row, epilogue).float()
        errs = {}
        for tree in ("this", "other"):
            fns[tree]()
            torch.cuda.synchronize()
            got = out[tree].float()
            if not (torch.isfinite(got).all() and torch.allclose(got, want, **TOL)):
                raise RuntimeError(f"{tree} GEMM disagrees with the plain product at {name}")
            errs[tree] = (got - want).abs().max().item()
        times = {"this": [], "other": []}
        for _ in range(rounds):
            for tree in ("other", "this", "this", "other"):
                times[tree].append(cuda_ms(fns[tree]))
        if b_row:
            cublas = lambda: torch.mm(a, b)  # noqa: E731
        else:
            cublas = lambda: torch.nn.functional.linear(a, b, bias)  # noqa: E731
        cublas_ms = min(cuda_ms(cublas), cuda_ms(cublas))
        ops = 2 * M * Nc * Kr
        nbytes = (M * Kr + Kr * Nc + M * Nc) * 2 + (0 if bias is None else Nc * 2)
        t_ops, t_bytes = ops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        best = min(times["this"])
        print(json.dumps({
            "shape": name, "M": M, "Kr": Kr, "Nc": Nc,
            "b_layout": "MN-major" if b_row else "K-major", "epilogue": epilogue,
            "this_ms": times["this"], "other_ms": times["other"], "cublas_ms": cublas_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "this_tflops": ops / best / 1e9,
            "this_over_cublas": best / cublas_ms, "max_abs_err": errs}), flush=True)


def _run(tree: Path, module: str, args) -> str:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-m", f"clip_dplm_tpu_torch.experiments.{module}",
                           *args], cwd=tree, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} {' '.join(args)} in {tree} failed:\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return proc.stdout


def step_turns(other: Path, models) -> None:
    """Each tree's bench step, in processes of their own, in turns."""
    for model in models:
        times = {"this": [], "other": []}
        for tree in ("other", "this", "this", "other"):
            stdout = _run(REPO if tree == "this" else other, "bench", ["--model", model])
            times[tree].append(json.loads(stdout.strip().splitlines()[-1])["step_ms"])
        print(json.dumps({"bench": model, "this_step_ms": times["this"],
                          "other_step_ms": times["other"]}), flush=True)


def profile_gemm(other: Path, model: str) -> None:
    """Each tree's profile_step: its GEMM kernel's device ms a step."""
    for tree in ("other", "this"):
        lines = [json.loads(x) for x in _run(REPO if tree == "this" else other, "profile_step",
                                             ["--model", model]).splitlines()
                 if x.startswith("{")]
        gemm = [x for x in lines if GEMM_KEY in x.get("kernel", "")]
        print(json.dumps({
            "profile": model, "tree": tree,
            "gemm_device_ms_per_step": sum(x["device_ms_per_step"] for x in gemm),
            "gemm_launches_per_step": sum(x["launches_per_step"] for x in gemm),
            "summary": lines[-1]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", default="", help="bench models to time in turns, comma-separated")
    ap.add_argument("--profile", default="", help="a bench model to profile in each tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    other = args.other.resolve()
    lib_this = _bind(_build.LIBRARY.get())
    for line in ptxas_lines(_build.LIBRARY.build_log, GEMM_KEY):
        print("this ptxas:", line)
    kernel_turns(lib_this, build_other(other), args.rounds)
    if args.steps:
        step_turns(other, args.steps.split(","))
    if args.profile:
        profile_gemm(other, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
