"""Build the package's CUDA kernels with nvcc, load them with ctypes, and
count their launches.

Every `.cu` file under `clip_dplm_tpu_torch/csrc/` is compiled, on first use,
into one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds). The library lands in `build/clip_dplm_tpu_torch/` under
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C launchers: name -> argtypes (pointers and the stream as c_void_p)
_SIGNATURES = {
    # qkv, mask, cos, sin, o, B, S, H, Dh, scale, stream
    "short_attention_qkv_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # x, w, bias, y, M, N, K, stream
    "short_attention_out_proj": [_P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, mask, out, B, H, S, Sk, Dh, scale, stream
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
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
    ["short_attention", "short_attention_out_proj", "flash_attention"])


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
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n"
                f"{self.build_log}")
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
