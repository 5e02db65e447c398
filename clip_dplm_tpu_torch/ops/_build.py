"""Build the package's CUDA kernels with nvcc, load them with ctypes, and
count their launches.

Every `.cu` file under `clip_dplm_tpu_torch/csrc/` is compiled, on first use,
into one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds): one nvcc process per source, all started together,
then one link. The library lands in `build/clip_dplm_tpu_torch/` under
the repository root, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the cached file. Each C launcher
takes raw pointers and the CUDA stream and returns `cudaGetLastError()`; the
Python wrappers in this package check shapes and types before calling it and
raise on a non-zero return (`launch`).

`LAUNCHES` counts, per kernel, the launches the wrappers made: a wrapper adds
one right after its kernel was launched and nowhere else, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "clip_dplm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float


class Operand(ctypes.Structure):
    """An attention operand as csrc/short_attention.cu's `Operand` takes it:
    row s of head h of batch row b at p + b·sb + h·sh + s·ss elements."""

    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_int64), ("sh", ctypes.c_int64),
                ("ss", ctypes.c_int64)]


_O = ctypes.POINTER(Operand)
# C launchers: name -> argtypes (pointers and the stream as c_void_p)
_SIGNATURES = {
    # qkv, mask, cos, sin, o, probs, B, S, H, Dh, scale, stream
    "short_attention_qkv_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # qkv, mask, cos, sin, o, dout, stats, dqkv, B, S, H, Dh, scale, stream
    "short_attention_qkv_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # qkv, cos, sin, probs, dout, stats, dqkv, B, S, H, Dh, scale, stream
    "short_attention_qkv_bwd_probs": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, o, B, S, H, Dh, scale, stream
    "short_attention_sep_fwd": [_O, _O, _O, _P, _O, _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, o, probs, B, S, H, Dh, scale, stream
    "short_attention_sep_fwd_save": [_O, _O, _O, _P, _O, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, o, dout, stats, dq, dk, dv, B, S, H, Dh, scale, stream
    "short_attention_sep_bwd": [_O, _O, _O, _P, _O, _O, _P, _O, _O, _O, _I, _I, _I, _I, _F, _P],
    # q, k, v, probs, dout, stats, dq, dk, dv, B, S, H, Dh, scale, stream
    "short_attention_sep_bwd_probs": [_O, _O, _O, _P, _O, _P, _O, _O, _O, _I, _I, _I, _I, _F,
                                      _P],
    # S, Dh, saved, kernel (0: dQ, 1: dK/dV, 2: the WMMA head kernel of the
    # recompute mode, 3: one block a head in saved mode, 4: one block a head in
    # recompute mode) -> shared memory bytes
    "short_attention_bwd_smem": [_I, _I, _I, _I],
    # design (0: one block a head, 1: the dQ and dK/dV pair) -> calls of the
    # backward from the probabilities that launched it
    "short_attention_saved_bwd_calls": [_I],
    # design (0: one block a head, 1: the WMMA head kernel, 2: the dQ and
    # dK/dV pair) -> calls of the recompute backward that launched it
    "short_attention_recompute_bwd_calls": [_I],
    # x, w, bias, y, M, N, K, stream
    "short_attention_out_proj": [_P, _P, _P, _P, _I, _I, _I, _P],
    # qkv, mask, out, B, S, H, Dh, scale, stream
    "cls_attention_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    # qkv, mask, dout, dqkv, B, S, H, Dh, scale, stream
    "cls_attention_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # design (0: one block a batch row and head group, 1: one block a batch
    # row) -> calls of the CLS backward that launched it
    "cls_attention_bwd_calls": [_I],
    # S, H, Dh -> shared memory bytes of the block the CLS backward launches
    "cls_attention_bwd_smem": [_I, _I, _I],
    # q, k, v, mask, out, lse, B, H, S, Sk, Dh, scale, stream
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, dout, lse, delta, dq, B, H, S, Sk, Dh, scale, stream
    "flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, dout, lse, delta, dk, dv, B, H, S, Sk, Dh, scale, stream
    "flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                _P],
    # qkv, mask, o, B, S, H, Dh, scale, stream
    "tiny_attention_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    # qkv, mask, o, dout, dqkv, B, S, H, Dh, scale, stream
    "tiny_attention_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # the f32 instances (csrc/tiny_attention_f32.cu), arguments as above
    "tiny_attention_fwd_f32": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "tiny_attention_bwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # A, B, bias, C, M, N, K, b_trans, stream (f32)
    "f32_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # A, B, bias, C, M, Nc, Kr, b_row, stream
    "fused_dense_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # s_buf, y, mean, rstd, gamma, beta, skip, ls, B, N, ln_act, act,
    # saves_pre, seed, thresh, keep, l2, y_f32, stream
    "fused_dense_fwd_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _U, _U, _F, _I, _I, _P],
    # dy, saved, mean, rstd, gamma, beta, skip, ls, du, dskip, dg, dbeta,
    # db, dls, work, B, N, ln_act, act, saves_pre, seed, thresh, keep, l2,
    # dy_f32, stream
    "fused_dense_bwd_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _I,
                             _I, _P],
    # N -> bytes of the backward row pass's scratch (-1: a width it refuses)
    "fused_dense_bwd_work": [_I],
    # x, y, scale, part, m, n, dp, nsplit, stream
    "sym_infonce_lse": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, y, scale, lse_row, lse_col, acc, rowdot, m, n, dp, stream
    "sym_infonce_grad": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, y, scale, part, raw_q, ldq, m, n, dp, nsplit, stream
    "sym_infonce_lse_save": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # part, nsplit, m, groups, n, row_lse, col_lse, stream
    "lse_combine": [_P, _I, _I, _I, _I, _P, _P, _P],
    # which (0: row_ce_lse, 1: sym_infonce_lse, 2: sym_infonce_lse_save) ->
    # calls that launched the wgmma walk lse_walk_kernel
    "lse_walk_calls": [_I],
    # raw_q, ldq, y, scale, lse_row, lse_col, acc_a, rowdot, m, n, dp, stream
    "sym_infonce_grad_raw": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # raw_q, ldq, x, scale, lse_row, lse_col, acc_b, m, n, dp, stream
    "sym_infonce_grad_rawT": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # which (0: sym_infonce_grad_raw, 1: sym_infonce_grad_rawT) -> calls that
    # launched the wgmma kernel from_raw_grad_kernel
    "from_raw_grad_calls": [_I],
    # raw_q, ldq, x, y, scale, lse_row, lse_col, acc_a, rowdot, part, acc_b,
    # m, n, dp, stream
    "sym_infonce_grad_merged": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, y, scale, n_valid, part, m, n, dp, nsplit, stream
    "row_ce_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, y, scale, n_valid, lse, py, rowdot, m, n, dp, stream
    "row_ce_dx": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, y, scale, lse, ptx, m, n_rows, dp, stream
    "row_ce_dy": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # which (0: row_ce_dx, 1: row_ce_dy, 2: sym_infonce_grad) -> calls that
    # launched the wgmma kernel row_ce_grad_kernel
    "row_ce_grad_calls": [_I],
}


class LaunchCounter:
    """Thread-safe per-kernel launch counts."""

    def __init__(self, names):
        self._lock = threading.Lock()
        self._counts = {n: 0 for n in names}

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            for n in self._counts:
                self._counts[n] = 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


LAUNCHES = LaunchCounter(
    ["short_attention", "short_attention_out_proj", "flash_attention",
     "fused_dense_gemm", "fused_dense_fwd_rows", "fused_dense_bwd_rows",
     "sym_infonce_lse", "sym_infonce_grad",
     "short_attention_bwd", "cls_attention_fwd", "cls_attention_bwd",
     "tiny_attention_fwd", "tiny_attention_bwd", "flash_attention_bwd_dq",
     "flash_attention_bwd_dkv", "row_ce_lse", "row_ce_dx", "row_ce_dy",
     "sym_infonce_lse_save", "sym_infonce_grad_raw", "sym_infonce_grad_rawT",
     "sym_infonce_grad_merged", "short_attention_save", "short_attention_bwd_probs",
     "short_attention_sep", "short_attention_sep_save", "short_attention_sep_bwd",
     "short_attention_sep_bwd_probs", "lse_combine", "tiny_attention_fwd_f32",
     "tiny_attention_bwd_f32", "out_proj_f32", "dout_f32"])


class _Library:
    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_seconds = 0.0  # 0 when a cached library was loaded
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.path = self._build()
                lib = ctypes.CDLL(str(self.path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.clip_dplm_error_string.argtypes = [ctypes.c_int]
                lib.clip_dplm_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def _build(self) -> Path:
        sources = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sorted(CSRC.glob("*.cu*")):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        out = BUILD_DIR / f"libclip_dplm_kernels_{digest.hexdigest()[:16]}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                             for src, o in zip(sources, objs))]
        logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        if all(rc == 0 for _, _, rc in logs):
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append((cmd, proc.stdout + proc.stderr, proc.returncode))
        self.build_seconds = time.perf_counter() - t0
        self.build_log = "".join(log for _, log, _ in logs)
        for o in objs:
            o.unlink(missing_ok=True)
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed with code {rc}: {' '.join(cmd)}\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never load a torn file
        return out


LIBRARY = _Library()


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled with "
                       "nvcc on first use (set CUDA_HOME or put nvcc on PATH)")


def launch(name: str, *args) -> None:
    """Call C launcher `name`; raise if the launch was refused."""
    lib = LIBRARY.get()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.clip_dplm_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """The current CUDA stream of `t`'s device, as the launchers take it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
