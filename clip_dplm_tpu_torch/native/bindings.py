"""ctypes bindings for the native tokenizer and collator (tokenizer.cpp).

Counterpart of `clip_dplm_tpu/native/bindings.py`, with the same numerical
contract as `data/protein.py::tokenize_batch` and
`data/collate.py::pad_token_batch` (the tests hold all four against each
other). `tokenizer.cpp` is compiled on first use with
`g++ -O3 -shared -fPIC -std=c++17` into `build/clip_dplm_tpu_torch/` under
the repository root, named by a hash of the source, the flags and the
compiler's version, so an edited source (or another g++) rebuilds and an
unchanged one loads the cached file. A failed build raises with the
compiler's message: there is no quiet fallback to the Python tokenizer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "clip_dplm_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


@functools.lru_cache(maxsize=None)
def compiler_version() -> str:
    """`g++ --version`'s text; raises RuntimeError where there is no g++."""
    try:
        return subprocess.run(["g++", "--version"], capture_output=True, text=True,
                              timeout=60).stdout
    except FileNotFoundError as err:
        raise RuntimeError("g++ not found: the native tokenizer is compiled with g++ "
                           "on first use") from err


def library_path() -> Path:
    """The library of this source, these flags and this g++."""
    digest = hashlib.sha256("\n".join([*FLAGS, compiler_version()]).encode()
                            + SOURCE.read_bytes()).hexdigest()
    return BUILD_DIR / f"libclip_dplm_tokenizer_{digest[:16]}.so"


def build() -> Path:
    """Compile tokenizer.cpp unless the library of this source exists;
    returns its path. Raises RuntimeError with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with code {proc.returncode}: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a torn file
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tokenize_batch.restype = ctypes.c_int32
            lib.tokenize_batch.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32,
            ]
            lib.pad_embedding_batch.restype = None
            lib.pad_embedding_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ]
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def tokenize_batch_native(
    seqs: Sequence[str],
    max_len: Optional[int] = None,
    pad_multiple: int = 8,
    replace_uzob: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Native equivalent of data.protein.tokenize_batch (same contract)."""
    lib = _load()
    blob = "".join(seqs).encode("ascii", errors="replace")
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    B = len(seqs)
    cap = max_len if max_len is not None else max(len(s) for s in seqs) + 2
    padded_cap = ((cap + pad_multiple - 1) // pad_multiple) * pad_multiple
    ids = np.empty((B, padded_cap), np.int32)
    mask = np.empty((B, padded_cap), np.uint8)
    used = lib.tokenize_batch(blob, _ptr(offsets, ctypes.c_int64), B, cap, pad_multiple,
                              int(replace_uzob), _ptr(ids, ctypes.c_int32),
                              _ptr(mask, ctypes.c_uint8), padded_cap)
    return ids[:, :used], mask[:, :used].astype(bool)


def pad_embedding_batch_native(
    seqs: Sequence[np.ndarray], max_len: Optional[int] = None,
    pad_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Native equivalent of data.collate.pad_token_batch (same contract)."""
    lib = _load()
    B = len(seqs)
    dim = seqs[0].shape[1]
    L = max(s.shape[0] for s in seqs)
    if max_len is not None:
        L = min(L, max_len)
    S = ((L + pad_multiple - 1) // pad_multiple) * pad_multiple
    src = np.ascontiguousarray(
        np.concatenate([s[:S].astype(np.float32, copy=False) for s in seqs]))
    offsets = np.zeros(B + 1, np.int64)
    np.cumsum([min(s.shape[0], S) for s in seqs], out=offsets[1:])
    out = np.empty((B, S, dim), np.float32)
    mask = np.empty((B, S), np.uint8)
    lib.pad_embedding_batch(_ptr(src, ctypes.c_float), _ptr(offsets, ctypes.c_int64), B, dim,
                            S, _ptr(out, ctypes.c_float), _ptr(mask, ctypes.c_uint8))
    return out, mask.astype(bool)
