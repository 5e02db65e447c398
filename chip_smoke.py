"""Smoke run of the PyTorch/CUDA port (clip_dplm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each fatal on failure (non-zero exit, no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from clip_dplm_tpu_torch/csrc/*.cu with nvcc;
  3. each kernel against its plain PyTorch version on the card, in bf16, at
     the serving path's shapes (bound atol = rtol = 2e-2), with both times;
     the packed short-S forward also at S=129 and 256 with Dh=128 (two
     blocks a head); the out-projection GEMM also at DPLM training's
     M=32768 (N=K=640; two launches equal byte for byte) beside cuBLAS; the
     GEMM's and the short-S forward's registers and spills, from ptxas;
  4. DPLM 640/12/10 logits on the card (kernel path) against the same
     weights on the CPU (plain path), bf16 on both, at S = 128 and 300;
  5. the HTTP server of experiments/serve.py on port 0 with random weights at
     full width (DPLM 640/12/10, 100 steps, 32 rows; ESM-2 650M, 32 rows, up
     to 1024 tokens): /healthz, /v1/embed across the 64..1024 buckets,
     /v1/generate; every serving launch counter must rise during this phase;
  6. the train path's kernels against their plain versions on the card, in
     bf16 (atol = rtol = 2e-2; gradients summed over the batch relative to
     their largest entry), forward and every gradient: fused Dense+LN at the
     two-tower step's four geometries at B=8192 and a ragged B=1000 (dropout
     masks equal bit for bit), the GEMM alone in both directions (x·W^T + b,
     B K-major, bias after a rounding; du·W, B MN-major, no bias) with two
     launches equal byte for byte, each beside cuBLAS at B=8192 1024->1024
     and 2048 -> 1024 (du·W); symmetric InfoNCE at B=8192 and B=1000, d=512;
  7. the two-tower train path at the widths of the repository's bench.py:
     (a) one train step on the card (kernels) against the same step on the
     CPU (plain versions) from the same weights and batch, bf16 both,
     dropout on: every leaf's gradient before the optimizer (over four
     dropout draws), the loss (over eight) and the update; at B=256 (the
     merged from-raw kernel) and B=512 (the two passes), each launching that schedule's kernels and not the other's; (b) the train CLI (experiments/train.py --device cuda) for
     3 epochs at B=256, whose loss must fall; (c) experiments/bench.py at
     B=8192 (pairs/s, MFU). Every train launch counter must rise in (b)+(c),
     the InfoNCE's as the default `fused_materialize_raw="auto"` has it: the
     saving forward and the from-raw schedule the port's shape rule picks
     (the eval step's forward saves nothing), the recompute pass not at all;
     then one CLI epoch with "never" must launch the recompute pass;
  8. the flagship RNA<->RBP token transformer (experiments/bench.py --model
     rna_rbp widths: towers 120/1280 -> 512, 3 blocks of 8 heads, S = 128):
     (a) the short-S attention backward, the CLS-query attention forward
     and backward against their plain versions on the card in bf16 (atol =
     rtol = 2e-2, gradients relative to their largest entry) at B=1024,
     with RoPE at DPLM's B=32 D=640, and ragged at B=1000 S=65, each timed
     beside SDPA (the library call of the same attention, timed only); the
     backward's rows name the design that ran, read from the C launcher's
     count of recompute calls by design (one block a head at S <= 128), and
     the CLS backward's rows theirs, from its launcher's count (one block a
     batch row and head group at S <= 256);
     flash attention with requires_grad records a gradient equal to its
     plain version's (atol = rtol = 2e-2 of the largest entry);
     (b) one flagship train step on the card against the CPU, B=16, dropout
     on, as 7(a); (c) the train CLI with experiment=rna_rbp at full width,
     B=256, 3 epochs, whose loss must fall; (d) experiments/bench.py --model
     rna_rbp at B=1024. The three new launch counters must rise in (c)+(d),
     and the saved-raw InfoNCE's as in 7; the packed attention's as the
     JAX package's size rule picks its mode there (saved at every shape of
     (c) and (d): the saving forward and the backward from the
     probabilities, the recompute backward not at all); (e) experiments/
     bench.py --model rna_rbp at B=2304, past the rule's 512 MiB (JAX's
     count: 604 MB a packed call), must launch the recompute backward (its
     one-block kernel at S=128, design 0 of the launcher's count, and no
     other design) and neither saved-mode kernel; then one flagship step
     card vs CPU at B=16 as (b) with the rule pinned to recompute, whose
     worst leaf is printed beside the saved mode's of (b); the kernels line
     takes the recompute backward's launches from (e);
  9. the tf_clip three-way step (experiments/bench.py --model tf_clip
     widths: three encoders of 3 blocks of 8 heads, d=512; gene_dim 2000 + 1,
     esm_dim 1280, 10 DEG tokens): (a) the tiny-S attention forward and
     backward (B=4096 S=10 D=512 H=8; B=1000 S=33 ragged; B=8192 S=8) and
     the flash backward's dQ and dK/dV kernels ((1, 8, 4096, 64) under a
     degree-style mask, the cell tower; ESM-2 650M's (32, 20, 1024, 64)
     ragged; S=300) against their plain versions on the card in bf16
     (atol = rtol = 2e-2, gradients relative to their largest entry, the
     backwards on the plain forward's residuals), the flash forward's lse
     against its plain version and, at the cell tower's shape, its output,
     each timed beside SDPA, and the two backward kernels' sum beside SDPA's
     whole backward at each shape (ptxas's registers and spills of every
     backward instance are printed after the build); (b) one tf_clip step
     on the card against the CPU at full width, B=256 (the cell tower is
     one sequence of 256 cells: the flash forward and backward), dropout on,
     as 7(a); (c) the train CLI with experiment=tf_clip, B=256, 3 epochs,
     whose loss must fall; (d) experiments/bench.py --model tf_clip at
     B=4096. The four new launch counters and flash_attention's must rise in
     (c)+(d), and the saved-raw InfoNCE's as in 7;
 10. the `two_tower_optimized` preset (the hard-negative cache with the
     fused loss): (a) the row cross-entropy's three kernels (row lse, P y
     with rowsum(p raw), P^T x) against their plain versions on the card in
     bf16 (atol = rtol = 2e-2, the backward outputs relative to their
     largest entry, on the plain lse): the a->b direction x (8192, 512)
     against [b; cache] (16384, 512) with n_valid = 8192 + 5000 (a partly
     filled cache) and dy for b's 8192 rows, the b->a direction (8192, 8192),
     and a ragged m=1000, n=1777, n_valid=1400 whose whole fused_row_ce
     (loss, dx, dy, dscale; shuffled labels) is held to its plain version;
     no single library call computes these functions; (b) one cached train
     step on the card against the CPU at the preset's widths (towers
     158/1280 -> 512), B=256, from the same weights, batch and warm cache
     (1024 rows, 640 filled, carried in with utils/convert.py::load_cache),
     dropout on, as 7(a), with cache_ptr and cache_len equal and the new
     cache rows within the same noise bound; (c) the train CLI with the
     preset's two overrides (B=128, cache 8192) for 3 epochs, whose loss
     must fall; (d) experiments/bench.py --model two_tower_cached at B=8192.
     The three new launch counters must rise in (c)+(d);
 11. the saved-raw InfoNCE (JAX's default on the three train paths): the
     saving forward (row and column lse, the int16 raw with |dq| <= 1), pass
     A (P y, rowdot), pass B (P^T x) and the merged kernel (all three in one
     pass over the raw) against their plain versions on the card in bf16
     (atol = rtol = 2e-2, the backward outputs relative to their largest
     entry, on the same raw and the plain lse) at B=8192 and 4096, d=512, a
     ragged B=1000 (partial tiles and clusters), B=256 and a ragged 200 (one
     cluster of the merged kernel, as the train CLIs run it); two launches
     of each kernel equal byte for byte; the whole fused_symmetric_infonce
     with materialize_raw=True: its backward against the plain backward on
     the raw and lse its own forward saved (da, db, dscale) at B=8192 and
     1000 on independent unit rows and at B=8192 and 256 on aligned pairs,
     and against its plain version end to end (loss, da, db, dscale) on the
     independent rows; its backward timed beside the recompute backward at
     B=8192; the merged and two-pass schedules timed in five alternating
     rounds, device and host-and-device time, at B=8192, 4096, 1024, 512,
     256, 200 and 128 beside the choice of the port's shape rule.
     No single library call computes these functions;
 12. DPLM training (experiment=dplm, DPLM 640/12/10): (a) the packed
     attention's saving forward (o and the bf16 probabilities) and its
     backward from the probabilities against their plain versions on the
     card in bf16 (atol = rtol = 2e-2, the backward outputs relative to
     their largest entry, on the plain forward's residuals) at DPLM's B=256,
     S=128, D=640, H=10 with RoPE, the flagship's B=1024, S=128, D=512, H=8,
     S=64, a ragged B=1000, S=65, S=255 at Dh=64 and Dh=128, where the
     recompute backward is held to its plain version too, and S=129 and 256
     at Dh=128; two launches of
     each equal byte for byte; each timed beside the recompute backward and
     SDPA (timed only); the backward's row names the design that ran, read
     from the C launcher's count of calls by design: the one-block kernel at
     S <= 128, the dQ and dK/dV pair past it; the recompute backward's line
     names its design the same way (one block at S <= 128, the WMMA head
     kernel past it where it fits, else the pair); (b) one DPLM train
     step on the card against the CPU
     at full width, B=8, S=64, the same weights and the same hash-drawn
     corruption, as 7(a); (c) one step at S=300 (the flash path: forward,
     dQ and dK/dV) with a finite loss; (d) the train CLI with
     experiment=dplm (S=64, B=128) for 3 epochs, whose loss must fall; (e)
     experiments/bench.py --model dplm at B=256, S=128. The two new launch
     counters must rise in (d)+(e), the recompute backward's not at all;
 13. the short-S attention over separate q, k, v (fused_short_attention,
     fused_short_attention_heads): its forward, saving forward, recompute
     backward and backward from the probabilities against their plain
     versions on the card in bf16 (atol = rtol = 2e-2, the backward outputs
     relative to their largest entry, on the plain forward's residuals) at
     the flagship's B=1024, S=128, D=512, H=8 from qkv.chunk(3, -1) views
     (read in place), at DPLM's B=256, S=128, H=10 as (B, H, S, Dh) heads
     after rotary_embed, ragged at B=1000, S=65, at S=255 with Dh=64 and
     Dh=128, at S=64 with no mask, and at S=129 and 256 with Dh=128; two
     launches of each equal byte for
     byte; each timed beside SDPA's forward or backward (timed only); at the
     flagship's shape the chunk views timed beside contiguous heads; both
     backwards name their design as in 12(a);
 14. the path of those kernels: (a) multihead_attention and
     attention_dispatch, forward and backward on the card at the flagship's
     and DPLM's full widths, launch only the separate-operand kernels in the
     mode the JAX size rule picks (saved at B=1024 and DPLM's B=256;
     recompute at the flagship's B=2304, 604 MB by JAX's count) and no plain
     version, with values and gradients against the plain formulation; (b)
     the flagship TransformerBlock's attention by its packed route
     (packed_qkv_attention_proj) and its separate route (multihead_attention
     over qkv.chunk(3, -1), then out_proj) on the same weights at B=1024: y,
     dqkv, dWo, dbo agree (atol = rtol = 2e-2 of the largest entry); (c) the
     same for one DPLM EsmBlock with RoPE at B=256, S=128: the packed RoPE
     kernel against rotary_embed, attention_dispatch and out (y, dh and
     every attention parameter's gradient). The kernels line takes the four
     launch counts from (a).
Prints a JSON line of per-kernel results (each kernel's time at its main
shape, its plain version's, the library call's where there is one, and the
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the dense peak of their type, 989 TFLOP/s bf16 or 67 TFLOP/s
f32), then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

TOL = dict(atol=2e-2, rtol=2e-2)  # the JAX suite's bf16 kernel bound
# Whole-model bound (bf16 on both sides, different summation orders): 3x the
# bf16-vs-f32 noise of this model on the CPU (rel L2 0.010, max abs 0.038).
MODEL_REL_L2, MODEL_MAX_ABS = 3e-2, 0.12
# Whole-step bound of 7(a): one train step, card (kernels) vs CPU (plain),
# bf16 both: STEP_NOISE_FACTOR x the bf16-vs-f32 difference of the same
# step on the CPU (loss, each leaf's gradient, update), measured in the same
# run (the port may add no more than a few times the rounding noise bf16
# itself causes). The loss is held over LOSS_DRAWS draws of the step's
# random numbers (dropout masks; DPLM's corruption), each with the gradient
# enabled as the step's own forward: error and noise are the RMS of the
# per-draw relative differences, since one draw's bf16-vs-f32 difference of
# a loss averaged over many tokens can fall near 0 by chance. Each leaf's
# gradient is held the same way over GRAD_DRAWS of those draws (the first
# ones): a leaf whose gradient is one cancelling sum (a layer scale before an
# L2 norm) swings with the last bit of its inputs, so one draw decides
# little (`leaf_noise_factor`).
STEP_NOISE_FACTOR = 3.0
LOSS_DRAWS = 8
GRAD_DRAWS = 4
SERVE_KERNELS = {  # launch-counter name -> (source, TPU kernel it replaces)
    "short_attention": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                        "clip_dplm_tpu/ops/short_attention.py:142"),
    "short_attention_out_proj": ("clip_dplm_tpu_torch/csrc/dense_gemm.cuh",
                                 "clip_dplm_tpu/ops/short_attention.py:142"),
    "flash_attention": ("clip_dplm_tpu_torch/csrc/flash_attention.cu",
                        "clip_dplm_tpu/ops/flash_attention.py:50"),
}
TRAIN_KERNELS = {
    "fused_dense_gemm": ("clip_dplm_tpu_torch/csrc/dense_gemm.cuh",
                         "clip_dplm_tpu/ops/fused_dense.py:292"),
    "fused_dense_fwd_rows": ("clip_dplm_tpu_torch/csrc/fused_dense.cu",
                             "clip_dplm_tpu/ops/fused_dense.py:292"),
    "fused_dense_bwd_rows": ("clip_dplm_tpu_torch/csrc/fused_dense.cu",
                             "clip_dplm_tpu/ops/fused_dense.py:517"),
    "sym_infonce_lse": ("clip_dplm_tpu_torch/csrc/fused_infonce.cu",
                        "clip_dplm_tpu/ops/fused_infonce.py:1296"),
    "sym_infonce_grad": ("clip_dplm_tpu_torch/csrc/fused_infonce.cu",
                         "clip_dplm_tpu/ops/fused_infonce.py:867"),
}
FLAGSHIP_KERNELS = {
    "short_attention_bwd": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                            "clip_dplm_tpu/ops/short_attention.py:583"),
    "cls_attention_fwd": ("clip_dplm_tpu_torch/csrc/cls_attention.cu",
                          "clip_dplm_tpu/ops/short_attention.py:950"),
    "cls_attention_bwd": ("clip_dplm_tpu_torch/csrc/cls_attention.cu",
                          "clip_dplm_tpu/ops/short_attention.py:973"),
}
TF_CLIP_KERNELS = {
    "tiny_attention_fwd": ("clip_dplm_tpu_torch/csrc/tiny_attention.cu",
                           "clip_dplm_tpu/ops/short_attention.py:1272"),
    "tiny_attention_bwd": ("clip_dplm_tpu_torch/csrc/tiny_attention.cu",
                           "clip_dplm_tpu/ops/short_attention.py:1300"),
    "flash_attention_bwd_dq": ("clip_dplm_tpu_torch/csrc/flash_attention.cu",
                               "clip_dplm_tpu/ops/flash_attention.py:233"),
    "flash_attention_bwd_dkv": ("clip_dplm_tpu_torch/csrc/flash_attention.cu",
                                "clip_dplm_tpu/ops/flash_attention.py:251"),
}
CACHE_KERNELS = {
    "row_ce_lse": ("clip_dplm_tpu_torch/csrc/row_ce.cu",
                   "clip_dplm_tpu/ops/fused_infonce.py:102"),
    "row_ce_dx": ("clip_dplm_tpu_torch/csrc/row_ce.cu",
                  "clip_dplm_tpu/ops/fused_infonce.py:212"),
    "row_ce_dy": ("clip_dplm_tpu_torch/csrc/row_ce.cu",
                  "clip_dplm_tpu/ops/fused_infonce.py:236"),
}
SAVED_RAW_KERNELS = {
    "sym_infonce_lse_save": ("clip_dplm_tpu_torch/csrc/fused_infonce.cu",
                             "clip_dplm_tpu/ops/fused_infonce.py:1220"),
    "sym_infonce_grad_merged": ("clip_dplm_tpu_torch/csrc/fused_infonce.cu",
                                "clip_dplm_tpu/ops/fused_infonce.py:665"),
    "sym_infonce_grad_raw": ("clip_dplm_tpu_torch/csrc/fused_infonce.cu",
                             "clip_dplm_tpu/ops/fused_infonce.py:754"),
    "sym_infonce_grad_rawT": ("clip_dplm_tpu_torch/csrc/fused_infonce.cu",
                              "clip_dplm_tpu/ops/fused_infonce.py:782"),
}
DPLM_KERNELS = {
    "short_attention_save": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                             "clip_dplm_tpu/ops/short_attention.py:537"),
    "short_attention_bwd_probs": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                                  "clip_dplm_tpu/ops/short_attention.py:583"),
}
SEPARATE_KERNELS = {
    "short_attention_sep": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                            "clip_dplm_tpu/ops/short_attention.py:412"),
    "short_attention_sep_save": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                                 "clip_dplm_tpu/ops/short_attention.py:412"),
    "short_attention_sep_bwd": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                                "clip_dplm_tpu/ops/short_attention.py:443"),
    "short_attention_sep_bwd_probs": ("clip_dplm_tpu_torch/csrc/short_attention.cu",
                                      "clip_dplm_tpu/ops/short_attention.py:443"),
}
KERNELS = {**SERVE_KERNELS, **TRAIN_KERNELS, **FLAGSHIP_KERNELS, **TF_CLIP_KERNELS,
           **CACHE_KERNELS, **SAVED_RAW_KERNELS, **DPLM_KERNELS, **SEPARATE_KERNELS}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 bandwidth
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 off the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call of fn, host launch overhead excluded: the calls
    are queued behind a sleeping kernel (~25 ms, longer than the host takes
    to enqueue them), so the events time the device work back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if enqueue_ms > 20.0:  # the sleep may have ended first: host gaps counted
        print(f"note: enqueueing the timed calls took {enqueue_ms:.1f} ms")
    return ms / iters


def bound(nbytes: float, ops: float, kind: str = "bf16"):
    """(bound_ms, bound_by): the least time for the work, the larger of the
    bytes over the memory rate and the operations over the peak of their
    type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, name, shape, kernel_fn, plain_fn, results, work=None, library_fn=None,
            normalize=False, library_ms=None):
    """Kernel vs plain on the same inputs: error and both device times
    (timed in turns plain, kernel, kernel, plain; the lower of each pair is
    kept), returned as (ms, plain_ms). A time covers all device work of the
    call, the wrapper's small set-up kernels included. With normalize, the
    error is relative to the plain output's largest entry (gradients). The
    library call is timed from `library_fn`, or given as `library_ms`."""
    got, want = kernel_fn().float(), plain_fn().float()
    torch.cuda.synchronize()
    scale = max(want.abs().max().item(), 1e-30) if normalize else 1.0
    err = (got - want).abs().max().item() / scale
    check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite output")
    check(torch.allclose(got / scale, want / scale, **TOL),
          f"{name} {shape}: max abs err {err} outside atol=rtol=2e-2")
    times = timed_pair(torch, kernel_fn, plain_fn)
    if library_fn is not None:
        library_ms = library_time(torch, library_fn)
    record(results, name, shape, err, *times, work=work, library_ms=library_ms)
    return times


def library_time(torch, fn):
    """Device ms of the library call that computes the same function (the
    lower of two timings), or None where there is none."""
    return None if fn is None else min(cuda_ms(torch, fn), cuda_ms(torch, fn))


def record(results, name, shape, err, ms, plain_ms, work=None, library_ms=None):
    """Per-kernel results; the first shape recorded is the main one and
    gives ms, plain_ms, library_ms and, from `work` = (bytes, ops, kind),
    the bound."""
    lib = "" if library_ms is None else f" library_ms={library_ms:.4f}"
    lim = "" if work is None else " bound_ms={:.4f} ({})".format(*bound(*work))
    print(f"kernel {name} {shape}: max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}"
          + lib + lim)
    entry = results.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if "ms" not in entry:
        check(work is not None, f"{name}: no work count for the main shape")
        entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
        entry["bound_ms"], entry["bound_by"] = bound(*work)


def timed_pair(torch, kernel_fn, plain_fn):
    """(kernel ms, plain ms), in turns plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return min(k1, k2), min(p1, p2)


def sdpa_fn(torch, q, k, v, mask):
    """SDPA forward over (B, H, S, Dh) with a (B, Sk) key mask: the library
    call of the same attention, timed only (the port never calls it)."""
    m = mask[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=m)


def sdpa_bwd_fn(torch, q, k, v, mask, dout):
    """SDPA's backward alone: one autograd call on a retained graph."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = sdpa_fn(torch, *leaves, mask)()
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def bwd_design(lib, what, S, Dh, fn, saved=True):
    """The design of the backward (from the probabilities, or recompute)
    that one call of fn launched, read from the C launcher's count of calls
    by design (`short_attention_saved_bwd_calls`,
    `short_attention_recompute_bwd_calls`): exactly one call, of the design
    the launcher's rule (`bwd_saved_design`, `bwd_recompute_design`) names
    at (S, Dh)."""
    from clip_dplm_tpu_torch.ops import short_attention as sa

    if saved:
        designs, count, rule = (("one block", "pair"), lib.short_attention_saved_bwd_calls,
                                sa.bwd_saved_design)
    else:
        designs, count, rule = (("one block", "head", "pair"),
                                lib.short_attention_recompute_bwd_calls, sa.bwd_recompute_design)
    before = [count(i) for i in range(len(designs))]
    fn()
    moved = [count(i) - before[i] for i in range(len(designs))]
    want = rule(S, Dh)
    check(moved == [int(d == want) for d in designs],
          f"{what}: calls by design {dict(zip(designs, moved))}, not one of the {want} design")
    return want


def cls_bwd_design(lib, what, S, D, H, fn):
    """The design of the CLS backward that one call of fn launched, read from
    the C launcher's count of calls by design (`cls_attention_bwd_calls`: 0
    one block a batch row and head group, 1 one block a batch row): exactly
    one call, of the design the launcher's rule (`cls_bwd_design`) names."""
    from clip_dplm_tpu_torch.ops import short_attention as sa

    designs = ("group", "row")
    before = [lib.cls_attention_bwd_calls(i) for i in range(2)]
    fn()
    moved = [lib.cls_attention_bwd_calls(i) - before[i] for i in range(2)]
    want = sa.cls_bwd_design(S, D, H)
    check(moved == [int(d == want) for d in designs],
          f"{what}: calls by design {dict(zip(designs, moved))}, not one of the {want} design")
    return want


def check_outputs(torch, what, got, want, names, raw_first=True):
    """Max abs error over outputs; the first is held to TOL as it is (unless
    raw_first is false), the rest (gradients, several summed over the batch,
    some of order 1/B) divided by their largest entry first."""
    worst = 0.0
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        a, b = a.float(), b.float()
        check(a.shape == b.shape, f"{what} {name}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
        check(bool(torch.isfinite(a).all()), f"{what} {name}: non-finite")
        scale = 1.0 if i == 0 and raw_first else max(b.abs().max().item(), 1e-30)
        err = ((a - b).abs().max().item()) / scale
        check(torch.allclose(a / scale, b / scale, **TOL),
              f"{what} {name}: max abs err {err} outside atol=rtol=2e-2")
        worst = max(worst, err)
    return worst


def phase_kernels(torch, results):
    from clip_dplm_tpu_torch.ops.attention import attention_reference
    from clip_dplm_tpu_torch.ops.flash_attention import flash_attention
    from clip_dplm_tpu_torch.ops.short_attention import (
        out_projection,
        out_projection_reference,
        short_attention_qkv,
        short_attention_qkv_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    # packed short-S kernel: DPLM generate (640/10) and ESM-2 650M (1280/20)
    for D, H in ((640, 10), (1280, 20)):
        B, S = 32, 128
        qkv = torch.randn(B, S, 3 * D, generator=g, device=dev).to(torch.bfloat16)
        mask, pos = ragged_mask(B, S), torch.arange(S, device=dev)
        shape = f"B={B} S={S} D={D} H={H} rope"
        main = D == 640  # the first shape is the one PERF.md tracks
        heads = [t.unflatten(-1, (H, D // H)).transpose(1, 2) for t in qkv.split(D, dim=-1)]
        compare(torch, "short_attention", shape,
                lambda: short_attention_qkv(qkv, H, mask=mask, rope_positions=pos),
                lambda: short_attention_qkv_reference(qkv, H, mask=mask,
                                                      rope_positions=pos),
                results, work=(B * S * 4 * D * 2 + B * S + S * 8, 4 * B * S * S * D),
                library_fn=sdpa_fn(torch, *heads, mask) if main else None)
        o = short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos)
        wo = torch.randn(D, D, generator=g, device=dev) / D ** 0.5
        bo = torch.randn(D, generator=g, device=dev) * 0.1
        M = B * S
        compare(torch, "short_attention_out_proj", f"M={M} N=K={D}",
                lambda: out_projection(o, wo, bo),
                lambda: out_projection_reference(o, wo, bo), results,
                work=(2 * M * D * 2 + D * D * 4 + D * 4, 2 * M * D * D),
                library_fn=(lambda: torch.nn.functional.linear(o, wo.bfloat16(), bo.bfloat16()))
                if main else None)
    # the out-projection at DPLM training's M = 256 rows x 128 tokens; two
    # launches equal byte for byte
    M, D = 32768, 640
    o = torch.randn(M, D, generator=g, device=dev).to(torch.bfloat16)
    wo = torch.randn(D, D, generator=g, device=dev) / D ** 0.5
    bo = torch.randn(D, generator=g, device=dev) * 0.1
    check(torch.equal(out_projection(o, wo, bo), out_projection(o, wo, bo)),
          f"short_attention_out_proj M={M}: two launches differ")
    compare(torch, "short_attention_out_proj", f"M={M} N=K={D} (DPLM training)",
            lambda: out_projection(o, wo, bo), lambda: out_projection_reference(o, wo, bo),
            results, work=(2 * M * D * 2 + D * D * 2 + D * 2, 2 * M * D * D),
            library_fn=lambda: torch.nn.functional.linear(o, wo.bfloat16(), bo.bfloat16()))
    # the packed forward past one block a head, at Dh=128: S=129 (a second
    # block of one row) and S=256 (two full blocks), the scores recomputed
    # over the resident K
    for S in (129, 256):
        B, D, H = 32, 1024, 8
        qkv = torch.randn(B, S, 3 * D, generator=g, device=dev).to(torch.bfloat16)
        mask, pos = ragged_mask(B, S), torch.arange(S, device=dev)
        compare(torch, "short_attention", f"B={B} S={S} D={D} H={H} rope",
                lambda: short_attention_qkv(qkv, H, mask=mask, rope_positions=pos),
                lambda: short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos),
                results, work=(B * S * 4 * D * 2 + B * S + S * 8, 4 * B * S * S * D))
    # flash kernel: ESM-2 650M embed, the 32-row 1024 bucket, then a ragged
    # last key tile (S=1000) and the smallest flash bucket
    for B, S in ((32, 1024), (8, 1000), (8, 256)):
        H, Dh = 20, 64
        q, k, v = (torch.randn(B, H, S, Dh, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        mask = ragged_mask(B, S)
        main = S == 1024
        compare(torch, "flash_attention", f"B={B} H={H} S={S} Dh={Dh}",
                lambda: flash_attention(q, k, v, mask=mask),
                lambda: attention_reference(q, k, v, mask=mask), results,
                work=(4 * B * H * S * Dh * 2 + B * S, 4 * B * H * S * S * Dh),
                library_fn=sdpa_fn(torch, q, k, v, mask) if main else None)


def phase_model(torch):
    from clip_dplm_tpu_torch.config import DPLMConfig
    from clip_dplm_tpu_torch.models.dplm import DPLM
    from clip_dplm_tpu_torch.models.layers import init_params

    cfg = DPLMConfig(max_len=302)
    gpu = DPLM(cfg, device="cuda")
    init_params(gpu, torch.Generator(device="cuda").manual_seed(1))
    cpu = DPLM(cfg)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(2)
    for S in (128, 300):
        toks = torch.randint(4, 24, (2, S), generator=g)
        toks[:, 0], toks[0, -1] = 0, 2
        L = 2 * S // 3  # second row ragged
        toks[1, L], toks[1, L + 1:] = 2, 1
        valid = toks != 1
        with torch.inference_mode():
            got = gpu(toks.cuda()).cpu()
            want = cpu(toks)
        check(got.shape == (2, S, cfg.vocab_size), f"logits shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"S={S}: non-finite logits")
        d = (got - want)[valid]
        rel = (d.norm() / want[valid].norm()).item()
        mx = d.abs().max().item()
        print(f"model DPLM 640/12/10 B=2 S={S}: card (kernels) vs CPU (plain): "
              f"rel_l2={rel:.3e} max_abs={mx:.3e}")
        check(rel <= MODEL_REL_L2 and mx <= MODEL_MAX_ABS,
              f"S={S}: logits outside rel_l2 <= {MODEL_REL_L2}, max_abs <= {MODEL_MAX_ABS}")


def _post(url, obj, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def phase_server(torch, build):
    from clip_dplm_tpu_torch.data.protein import RESIDUES, random_protein
    from clip_dplm_tpu_torch.experiments import serve
    from clip_dplm_tpu_torch.serving import make_server

    args = serve.parse_args([
        "--device", "cuda", "--allow-random", "--esm", "esm2_t33_650M",
        "--max-len", "1024", "--max-batch", "32", "--dplm-random",
        "--dplm-d-model", "640", "--dplm-layers", "12", "--gen-max-len", "126",
        "--gen-steps", "100", "--gen-max-batch", "32", "--port", "0"])
    dim = serve.esm_config_from_name(args.esm).d_model
    embed_svc, gen_svc = serve.build_services(args)
    server = make_server(embed=embed_svc, generate=gen_svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    rng = np.random.default_rng(0)
    residues = set(RESIDUES)
    rates = {}
    try:
        build.LAUNCHES.reset()
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            check(json.loads(resp.read().decode()) == {"ok": True}, "healthz")
        # one request per bucket group: 64, 128 (packed kernel), 512, 1024 (flash)
        for lens in ((50, 60), (100, 120), (300,), (900, 1000)):
            seqs = [random_protein(rng, n) for n in lens]
            status, body = _post(f"{base}/v1/embed", {"sequences": seqs})
            emb = np.asarray(body["embeddings"], np.float32)
            check(status == 200 and body["dim"] == dim and emb.shape == (len(lens), dim),
                  f"embed {lens}: status {status}, shape {emb.shape}")
            check(bool(np.isfinite(emb).all()), f"embed {lens}: non-finite")
        for req, want in (({"lengths": [60, 124]}, [60, 124]),
                          ({"num": 4, "length": 100}, [100] * 4)):
            status, body = _post(f"{base}/v1/generate", req)
            seqs = body["sequences"]
            check(status == 200 and [len(s) for s in seqs] == want,
                  f"generate {req}: status {status}, lengths {[len(s) for s in seqs]}")
            check(all(set(s) <= residues for s in seqs), f"generate {req}: non-residue")
            check(all(np.isfinite(body["confidence"])), f"generate {req}: confidence")
        # full batches: one 32-row program each
        t0 = time.perf_counter()
        status, body = _post(f"{base}/v1/generate", {"num": 32, "length": 126})
        rates["generate L=126 100 steps"] = 32 / (time.perf_counter() - t0)
        check(status == 200 and len(body["sequences"]) == 32, "generate x32")
        for n in (100, 300, 1000):
            seqs = [random_protein(rng, n) for _ in range(32)]
            t0 = time.perf_counter()
            status, body = _post(f"{base}/v1/embed", {"sequences": seqs})
            rates[f"embed L={n}"] = 32 / (time.perf_counter() - t0)
            check(status == 200 and len(body["embeddings"]) == 32, f"embed x32 L={n}")
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()
    finally:
        server.shutdown()
        server.server_close()
        embed_svc.close()
        gen_svc.close()
    for name, rate in rates.items():
        print(f"service {name}: {rate:.2f} seqs/s (one request of 32 sequences)")
    print(f"launches during the server phase: {launches}")
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the server path")
    return launches


FD_GEOMETRIES = [  # what, B, K, N, order, act, dropout, skip tail
    ("tower final", 8192, 1024, 1024, "act_ln", "relu", 0.0, False),
    ("head fc0", 8192, 1024, 2048, "ln_act", "gelu", 0.1, False),
    ("head fc1", 8192, 2048, 2048, "ln_act", "gelu", 0.1, False),
    ("head fc_out", 8192, 2048, 512, "ln_act", "none", 0.0, True),
    ("head fc0 ragged", 1000, 1024, 2048, "ln_act", "gelu", 0.1, False),
]


def phase_train_kernels(torch, results):
    from clip_dplm_tpu_torch.ops import fused_dense as fd
    from clip_dplm_tpu_torch.ops import fused_infonce as fi

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    for what, B, K, N, order, act, rate, skip in FD_GEOMETRIES:
        x, w = rnd(B, K).bfloat16(), rnd(N, K) / K ** 0.5
        b, gm, bt = rnd(N) * 0.1, 1.0 + 0.1 * rnd(N), rnd(N) * 0.1
        extra = (rnd(B, N).bfloat16(), torch.tensor([0.3], device=dev)) if skip else ()
        out_dtype = torch.float32 if (skip or order == "act_ln") else torch.bfloat16
        dy = rnd(B, N).to(out_dtype)
        kw = dict(order=order, act=act, dropout_rate=rate, dropout_seed=777,
                  deterministic=rate == 0.0, out_dtype=out_dtype)
        shape = f"{what} B={B} K={K} N={N} {order} {act}" + (f" dropout {rate}" if rate else "")
        # forward on the same inputs; then the whole backward (row kernels,
        # dx GEMM, dW) on the same inputs (dy and the kernel forward's
        # residuals): a relu whose input rounds to the other side of 0 in one
        # of two forwards would flip a whole du entry, which is rounding, not
        # a kernel fault
        spec = fd._Spec(order, act, rate, 777, torch.bfloat16, out_dtype, False)
        wc, sk = w.bfloat16(), extra if skip else (None, None)
        fwd_k = fd._kernel_fwd(spec, x, wc, b, gm, bt, *sk)
        fwd_p = fd._plain_fwd(spec, x, wc, b, gm, bt, *sk)
        if rate:
            check(torch.equal(fwd_k[0] == 0, fwd_p[0] == 0),
                  f"fused_dense {shape}: dropout masks differ")
        err = check_outputs(torch, f"fused_dense {shape} forward", fwd_k[:2], fwd_p[:2],
                            ["y", "saved"])
        bwd = [fd._backward(spec, dy, x, wc, gm, bt, *fwd_k[1:], None, sk[1], use_kernel=k)
               for k in (True, False)]
        names = ["dx", "dW", "db", "dgamma", "dbeta"] + (["dls", "dskip"] if skip else [])
        berr = check_outputs(torch, f"fused_dense {shape} backward", bwd[0][:len(names)],
                             bwd[1][:len(names)], names)
        dx_err = check_outputs(torch, f"fused_dense_gemm {shape} dx", bwd[0][:1], bwd[1][:1],
                               ["dx"])
        torch.cuda.synchronize()
        # forward (GEMM + row epilogue) and backward (row pass + dx GEMM + dW)
        fkw = dict(kw, skip=extra[0], layer_scale=extra[1]) if skip else kw
        with torch.no_grad():
            ms, plain_ms = timed_pair(
                torch, lambda: fd.fused_dense_norm_act(x, w, b, gm, bt, **fkw),
                lambda: fd.fused_dense_reference(x, w, b, gm, bt, **fkw))
        # bytes: x, W (f32), bias/gamma/beta in, y out; ops: the product
        work = (B * K * 2 + N * K * 4 + 3 * N * 4 + B * N * out_dtype.itemsize, 2 * B * N * K)
        record(results, "fused_dense_fwd_rows", shape + " forward", err, ms, plain_ms, work=work)
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b, gm, bt)]
        graphs = {k: fn(*leaves, **fkw) for k, fn in
                  (("kernel", fd.fused_dense_norm_act), ("plain", fd.fused_dense_reference))}
        ms, plain_ms = timed_pair(
            torch, lambda: graphs["kernel"].backward(dy, retain_graph=True),
            lambda: graphs["plain"].backward(dy, retain_graph=True))
        # bytes: dy, x, W (bf16), the saved pre-LN rows and stats, gamma/beta in;
        # dx, dW (f32), db/dgamma/dbeta out; ops: the dx and dW products
        work = (B * N * out_dtype.itemsize + B * K * 2 + N * K * 2 + B * N * 2 + B * 8
                + 2 * N * 4 + B * K * 2 + N * K * 4 + 3 * N * 4, 4 * B * N * K)
        record(results, "fused_dense_bwd_rows", shape + " backward", berr, ms, plain_ms,
               work=work)
        del graphs
        # the GEMM alone against cuBLAS (u = bf16(x W^T) + b)
        wb, bb = wc.contiguous(), b.bfloat16()
        got = fd._gemm(x, wb, bb, N, b_row=False)
        want = (x.float() @ wb.float().t()).bfloat16() + bb
        gerr = check_outputs(torch, f"fused_dense_gemm {shape}", [got], [want], ["u"])
        check(torch.equal(got, fd._gemm(x, wb, bb, N, b_row=False)),
              f"fused_dense_gemm {shape}: two launches differ")
        ms, plain_ms = timed_pair(
            torch, lambda: fd._gemm(x, wb, bb, N, b_row=False),
            lambda: (x.float() @ wb.float().t()).bfloat16() + bb)
        record(results, "fused_dense_gemm", f"M={B} N={N} K={K} (x W^T + b)",
               max(gerr, dx_err), ms, plain_ms,
               work=(B * K * 2 + N * K * 2 + N * 2 + B * N * 2, 2 * B * N * K),
               library_ms=library_time(torch, lambda: torch.nn.functional.linear(x, wb, bb)))
        # the other direction alone against cuBLAS: dx = du·W, B = W row-major
        # (MN-major), no bias; at 1024 -> 2048 that is Kr = 2048 -> Nc = 1024
        du = rnd(B, N).bfloat16()
        got = fd._gemm(du, wb, None, K, b_row=True)
        check(torch.equal(got, fd._gemm(du, wb, None, K, b_row=True)),
              f"fused_dense_gemm {shape} du W: two launches differ")
        if B == 8192 and (K, N) == (1024, 2048):
            want = (du.float() @ wb.float()).bfloat16()
            derr = check_outputs(torch, f"fused_dense_gemm {shape} du W", [got], [want], ["dx"])
            ms, plain_ms = timed_pair(torch, lambda: fd._gemm(du, wb, None, K, b_row=True),
                                      lambda: (du.float() @ wb.float()).bfloat16())
            record(results, "fused_dense_gemm", f"M={B} Kr={N} Nc={K} (du W, B MN-major)",
                   derr, ms, plain_ms, work=(B * N * 2 + N * K * 2 + B * K * 2, 2 * B * N * K),
                   library_ms=library_time(torch, lambda: torch.mm(du, wb)))
    for B in (8192, 1000):
        d = 512
        a = torch.nn.functional.normalize(rnd(B, d), dim=-1)
        bb = torch.nn.functional.normalize(a + 0.5 * rnd(B, d), dim=-1)
        scale = torch.tensor(14.2857, device=dev)
        outs, graphs = {}, {}
        for key, fn in (("kernel", fi.fused_symmetric_infonce),
                        ("plain", fi.fused_symmetric_infonce_reference)):
            leaves = [t.clone().requires_grad_(True) for t in (a, bb, scale)]
            loss = fn(*leaves, torch.bfloat16)
            loss.backward(retain_graph=True)
            outs[key] = [loss.detach()] + [t.grad for t in leaves]
            graphs[key] = loss
        torch.cuda.synchronize()
        shape = f"B={B} d={d}"
        err = check_outputs(torch, f"sym_infonce {shape}", outs["kernel"], outs["plain"],
                            ["loss", "da", "db", "dscale"])
        with torch.no_grad():
            ms, plain_ms = timed_pair(
                torch, lambda: fi.fused_symmetric_infonce(a, bb, scale, torch.bfloat16),
                lambda: fi.fused_symmetric_infonce_reference(a, bb, scale, torch.bfloat16))
        record(results, "sym_infonce_lse", shape + " forward", err, ms, plain_ms,
               work=(2 * B * d * 4 + 4 + 4, 2 * B * B * d))
        ms, plain_ms = timed_pair(torch, lambda: graphs["kernel"].backward(retain_graph=True),
                                  lambda: graphs["plain"].backward(retain_graph=True))
        # two recompute passes, each a similarity tile product and a contraction
        record(results, "sym_infonce_grad", shape + " backward (two passes + tail)", err, ms,
               plain_ms, work=(4 * B * d * 4 + 2 * B * 4, 8 * B * B * d))
        del graphs


def loss_kernels(*batches):
    """The InfoNCE launch counters a default ("auto") train path at these
    batch sizes must raise: the saving forward and the from-raw schedule the
    port's shape rule picks for each batch."""
    from clip_dplm_tpu_torch.ops import fused_infonce as fi

    names = {"sym_infonce_lse_save"}
    for B in batches:
        names.update(["sym_infonce_grad_merged"] if fi._from_raw_merged(B)
                     else ["sym_infonce_grad_raw", "sym_infonce_grad_rawT"])
    return sorted(names)


def check_saved_raw_path(launches, what, *batches):
    for name in loss_kernels(*batches):
        check(launches[name] > 0, f"kernel {name} was not launched by the {what} path")
    check(launches["sym_infonce_grad"] == 0,
          f"the {what} path ran the recompute pass under fused_materialize_raw=auto")


def _rel(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def phase_train_step(torch, build):
    """7(a): the two-tower step at bench widths, card vs CPU, at B=256 and
    512: the two from-raw schedules of the port's shape rule."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    rng = np.random.default_rng(5)
    for B in (256, 512):
        cfg = apply_overrides(Config(), bench.OVERRIDES + [
            f"train.batch_size={B}", "train.optim.schedule=constant",
            "train.optim.learning_rate=1e-3"])
        batch = {"a": rng.normal(size=(B, 256)).astype(np.float32),
                 "b": rng.normal(size=(B, 1280)).astype(np.float32)}
        build.LAUNCHES.reset()
        step_card_vs_cpu(torch, f"train step B={B} (bench widths, dropout 0.1)", cfg, batch)
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()
        check_saved_raw_path(launches, f"B={B} step", B)
        other = [k for k in SAVED_RAW_KERNELS if k not in loss_kernels(B) and launches[k]]
        check(not other, f"train step B={B}: the other from-raw schedule ran too ({other})")
        print(f"train step B={B}: InfoNCE kernels {', '.join(loss_kernels(B))}")


def rms(values) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(values, dtype=np.float64)))))


def leaf_noise_factor(errs, noises, floors):
    """(error, noise, factor) of one leaf over the draws of a step check:
    the RMS over draws of the card's relative L2 error against the CPU's bf16
    run (`errs`), the bound's noise as the larger of the RMS over draws of
    the leaf's own bf16-vs-f32 difference (`noises`) and of the whole
    gradient's (`floors`), and the first over the second. The check holds
    factor <= STEP_NOISE_FACTOR."""
    err = rms(errs)
    noise = max(rms(noises), rms(floors), 1e-30)
    return err, noise, err / noise


def step_card_vs_cpu(torch, what, cfg, batch, cache=None):
    """One train step on the card vs the same step on the CPU from the same
    weights and batch (bf16 both, the same dropout masks): the gradient of
    every leaf before the optimizer, then the loss and the update, each
    within STEP_NOISE_FACTOR x its bf16-vs-f32 noise on the CPU. With `cache`
    = (rows, ptr, filled) every run starts from that hard-negative cache;
    the new cache_ptr and cache_len must then be equal, the untouched rows
    unchanged and the written rows within the same bound. The loss is
    compared over LOSS_DRAWS seeds (the step's and the next ones, with the
    gradient enabled), error and noise as the RMS of the per-seed relative
    differences; each leaf's gradient over the first GRAD_DRAWS of them
    (`leaf_noise_factor`). The optimizer step is taken once, on the step's
    own seed."""
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import make_loss_fn, make_train_step, to_device
    from clip_dplm_tpu_torch.utils.convert import load_cache

    t0 = time.perf_counter()
    gpu = build_model(cfg, device="cuda")
    create_train_state(gpu, cfg)  # random weights from the seed
    sd = {k: v.detach().cpu().clone() for k, v in gpu.state_dict().items()}
    runs, caches, draws, grads = {}, {}, {}, {}
    for name, device, dtype in (("card", "cuda", torch.bfloat16),
                                ("cpu", "cpu", torch.bfloat16),
                                ("cpu_f32", "cpu", torch.float32)):
        model = gpu if name == "card" else build_model(cfg, device=device, dtype=dtype)
        model.load_state_dict(sd)
        state = create_train_state(model, cfg, init=False)
        if cache is not None:
            load_cache(state, *cache)
        dev_batch = to_device(batch, device)
        # draw i takes the seeds of step + i; the first GRAD_DRAWS also give
        # the gradient (the step's own seeds first), the rest the loss alone,
        # through the step's graph mode (the packed attention's saved mode
        # where the rule picks it)
        draws[name], grads[name] = [], []
        for i in range(LOSS_DRAWS):
            loss, _ = make_loss_fn(cfg)(model, dev_batch, DropoutSeeds(state.key, state.step + i),
                                        state.cache, state.cache_len)
            if i < GRAD_DRAWS:
                for p in model.parameters():
                    p.grad = None
                loss.backward()
                grads[name].append({k: p.grad.detach().cpu().float()
                                    for k, p in model.named_parameters()})
            draws[name].append(float(loss.detach()))
        for p in model.parameters():
            p.grad = None
        state, metrics = make_train_step(cfg)(state, dev_batch)
        runs[name] = (float(metrics["loss"]), torch.cat([
            (p.detach().cpu().float() - sd[k]).flatten()
            for k, p in model.named_parameters()]))
        if cache is not None:
            caches[name] = (state.cache.cpu(), int(state.cache_ptr), int(state.cache_len))
        del state, model
    (l_card, d_card), (l_cpu, d_cpu), (l_f32, d_f32) = (
        runs[k] for k in ("card", "cpu", "cpu_f32"))
    check(np.isfinite(l_card) and bool(torch.isfinite(d_card).all()), f"{what}: non-finite")
    # per leaf, over the draws: the card's gradient against the CPU's,
    # bounded by the bf16-vs-f32 noise of that leaf or of the whole
    # gradient, the larger; draw 0 alone is the one-draw statistic, printed
    # beside it
    g_card, g_cpu, g_f32 = (grads[k] for k in ("card", "cpu", "cpu_f32"))
    leaves = list(g_cpu[0])

    def flat(g):
        return torch.cat([g[k].flatten() for k in leaves])

    grad_errs = [_rel(flat(a), flat(b)) for a, b in zip(g_card, g_cpu)]
    grad_noises = [_rel(flat(a), flat(b)) for a, b in zip(g_f32, g_cpu)]
    worst, worst_leaf, one, one_leaf, held = 0.0, "", 0.0, "", []
    for k in leaves:
        check(all(bool(torch.isfinite(g[k]).all()) for g in g_card), f"{what} grad {k}: non-finite")
        errs = [_rel(a[k], b[k]) for a, b in zip(g_card, g_cpu)]
        noises = [_rel(a[k], b[k]) for a, b in zip(g_f32, g_cpu)]
        err, noise, factor = leaf_noise_factor(errs, noises, grad_noises)
        first = leaf_noise_factor(errs[:1], noises[:1], grad_noises[:1])[2]
        if factor > worst:
            worst, worst_leaf = factor, k
        if first > one:
            one, one_leaf = first, k
        held.append((factor, f"{what} grad {k}: rel L2 {err} > {STEP_NOISE_FACTOR} x noise "
                             f"{noise} (RMS over {GRAD_DRAWS} draws; per draw: err {errs}, "
                             f"noise {noises})"))
    ref = np.array(draws["cpu"])
    per_draw = {k: (np.array(draws[k]) - ref) / ref for k in ("card", "cpu_f32")}
    loss_err, loss_noise = (rms(per_draw[k]) for k in per_draw)
    upd_err, upd_noise = _rel(d_card, d_cpu), _rel(d_f32, d_cpu)
    print(f"{what}: loss card {l_card:.6f} cpu "
          f"{l_cpu:.6f} cpu_f32 {l_f32:.6f}; loss rel err {loss_err:.3e} (bf16 noise "
          f"{loss_noise:.3e}, RMS over {LOSS_DRAWS} seeds; per seed: err "
          f"{' '.join(f'{x:.1e}' for x in per_draw['card'])}, noise "
          f"{' '.join(f'{x:.1e}' for x in per_draw['cpu_f32'])}); "
          f"gradient rel L2 {rms(grad_errs):.3e} (bf16 noise {rms(grad_noises):.3e}, RMS over "
          f"{GRAD_DRAWS} draws), worst leaf {worst:.3f} x its noise ({worst_leaf}) over "
          f"{len(leaves)} leaves, RMS over {GRAD_DRAWS} draws (draw 0 alone: {one:.3f}x "
          f"({one_leaf})); update rel L2 {upd_err:.3e} (bf16 noise {upd_noise:.3e}); "
          f"{time.perf_counter() - t0:.1f} s")
    for factor, msg in held:
        check(factor <= STEP_NOISE_FACTOR, msg)
    result = worst, worst_leaf
    check(loss_err <= STEP_NOISE_FACTOR * loss_noise + 1e-6,
          f"{what} loss: rel err {loss_err} > {STEP_NOISE_FACTOR} x noise {loss_noise}")
    check(upd_err <= STEP_NOISE_FACTOR * upd_noise,
          f"{what} update: rel L2 {upd_err} > {STEP_NOISE_FACTOR} x noise {upd_noise}")
    if cache is not None:
        rows, ptr, B = cache[0].shape[0], int(cache[1]), next(iter(batch.values())).shape[0]
        start = 0 if ptr + B > rows else ptr
        (c_card, p_card, l_card), (c_cpu, p_cpu, l_cpu), (c_f32, _, _) = (
            caches[k] for k in ("card", "cpu", "cpu_f32"))
        check((p_card, l_card) == (p_cpu, l_cpu) == ((start + B) % rows,
                                                     max(int(cache[2]), start + B)),
              f"{what}: cache_ptr / cache_len card {(p_card, l_card)} cpu {(p_cpu, l_cpu)}")
        new = slice(start, start + B)
        kept = torch.ones(rows, dtype=torch.bool)
        kept[new] = False
        check(torch.equal(c_card[kept], torch.from_numpy(cache[0])[kept]),
              f"{what}: cache rows outside the write changed")
        c_err, c_noise = _rel(c_card[new], c_cpu[new]), _rel(c_f32[new], c_cpu[new])
        print(f"{what}: cache_ptr {p_card} cache_len {l_card} on both; new cache rows "
              f"{start}..{start + B - 1} rel L2 {c_err:.3e} (bf16 noise {c_noise:.3e})")
        check(c_err <= STEP_NOISE_FACTOR * c_noise,
              f"{what} cache rows: rel L2 {c_err} > {STEP_NOISE_FACTOR} x noise {c_noise}")
    return result


def phase_train_path(torch, build):
    """7(b) the train CLI, 7(c) the benchmark; the launch counts of both."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.experiments import train as train_cli

    build.LAUNCHES.reset()
    overrides = bench.OVERRIDES + ["train.batch_size=256", "train.optim.warmup_steps=5",
                                   "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli.main(["--device", "cuda", "--epochs", "3",
                           *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"train CLI losses {losses}")
    check(losses[-1] < losses[0], f"train CLI: loss did not fall: {losses}")
    print(f"train CLI (bench widths, B=256, 3 epochs of 6 steps): train_loss {losses}, "
          f"val_loss {hist['val_loss']}, {cli_s:.1f} s")
    out = bench.main(["--batch", "8192"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench B=8192: step {out['step_ms']} ms, {out['value']} pairs/s, "
          f"{out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU {out['mfu']} of "
          f"{out['peak_bf16_tflops']} TFLOP/s bf16 peak")
    print(f"launches during the train phase: {launches}")
    for name in TRAIN_KERNELS:
        if name != "sym_infonce_grad":
            check(launches[name] > 0, f"kernel {name} was not launched by the train path")
    check_saved_raw_path(launches, "train", 256, 8192)
    # the recompute pass is what "never" runs: one CLI epoch with it
    build.LAUNCHES.reset()
    never = ["-o", "contrastive.fused_materialize_raw=never"]
    hist = train_cli.main(["--device", "cuda", "--epochs", "1", *never,
                           *[a for o in overrides for a in ("-o", o)]])
    torch.cuda.synchronize()
    counts = build.LAUNCHES.snapshot()
    check(np.isfinite(hist["train_loss"][0]), f"train CLI (never) loss {hist['train_loss']}")
    check(counts["sym_infonce_grad"] > 0 and counts["sym_infonce_lse_save"] == 0,
          f"train CLI with fused_materialize_raw=never: launches {counts}")
    print(f"train CLI with fused_materialize_raw=never (B=256, 1 epoch): train_loss "
          f"{hist['train_loss']}, sym_infonce_grad launched {counts['sym_infonce_grad']} times")
    launches["sym_infonce_grad"] = counts["sym_infonce_grad"]
    return launches


def phase_flagship_kernels(torch, results):
    """8(a): the flagship's three new kernels against their plain versions,
    each timed beside SDPA at the same shape; and flash attention recording
    its gradient."""
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import short_attention as sa
    from clip_dplm_tpu_torch.ops.attention import attention_reference
    from clip_dplm_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    def heads(t, H):
        return t.unflatten(-1, (H, -1)).transpose(1, 2)

    # (B, S, D, H, rope): the flagship block, DPLM's geometry with RoPE, ragged
    for B, S, D, H, rope in ((1024, 128, 512, 8, False), (32, 128, 640, 10, True),
                             (1000, 65, 512, 8, False)):
        main = B == 1024
        qkv, dout, mask = rnd(B, S, 3 * D), rnd(B, S, D), ragged_mask(B, S)
        pos = torch.arange(S, device=dev) if rope else None
        o = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos)
        q, k, v = (heads(t, H) for t in qkv.split(D, dim=-1))
        shape = f"B={B} S={S} D={D} H={H}" + (" rope" if rope else "")
        design = bwd_design(_build.LIBRARY.get(), f"short_attention_bwd {shape}", S, D // H,
                            lambda: sa.short_attention_qkv_bwd(dout, qkv, o, H, mask=mask,
                                                               rope_positions=pos),
                            saved=False)
        # bytes: qkv, o, dO, mask in, dqkv out; ops: five (S, S, Dh) products a head
        compare(torch, "short_attention_bwd",
                shape + f" (on the plain forward's residuals; {design})",
                lambda: sa.short_attention_qkv_bwd(dout, qkv, o, H, mask=mask,
                                                   rope_positions=pos),
                lambda: sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, mask=mask,
                                                             rope_positions=pos),
                results, work=(B * S * 8 * D * 2 + B * S, 10 * B * S * S * D),
                library_fn=sdpa_bwd_fn(torch, q, k, v, mask, heads(dout, H)) if main else None,
                normalize=True)
        if rope:
            continue
        do1 = rnd(B, 1, D)
        q0 = q[:, :, :1]
        with torch.no_grad():
            # bytes: q row 0, K, V, mask in, (B, 1, D) out; f32 ops: scores and value sum
            compare(torch, "cls_attention_fwd", shape,
                    lambda: sa.fused_cls_attention(qkv, H, mask=mask),
                    lambda: sa.fused_cls_attention_reference(qkv, H, mask=mask), results,
                    work=(B * D * 2 + 2 * B * S * D * 2 + B * S + B * D * 2, 4 * B * S * D,
                          "f32"),
                    library_fn=sdpa_fn(torch, q0, k, v, mask) if main else None)
        cls_design = cls_bwd_design(_build.LIBRARY.get(), f"cls_attention_bwd {shape}", S, D,
                                    H, lambda: sa.fused_cls_attention_bwd(do1, qkv, H, mask=mask))
        # bytes: q row 0, dO, K, V, mask in, dqkv out; f32 ops: scores, dp, dq, dk, dv
        compare(torch, "cls_attention_bwd", shape + f" ({cls_design} design)",
                lambda: sa.fused_cls_attention_bwd(do1, qkv, H, mask=mask),
                lambda: sa.fused_cls_attention_bwd_reference(do1, qkv, H, mask=mask),
                results, work=(2 * B * D * 2 + 2 * B * S * D * 2 + B * S + B * S * 3 * D * 2,
                               8 * B * S * D, "f32"),
                library_fn=sdpa_bwd_fn(torch, q0, k, v, mask, heads(do1, H)) if main else None,
                normalize=True)
    # flash attention records its gradient: the card's (kernels) against
    # autograd of the plain formulation on the same inputs
    q, k, v, dout = (rnd(2, 2, 256, 64) for _ in range(4))
    mask = torch.arange(256, device=dev)[None, :] < torch.tensor([[256], [200]], device=dev)
    grads = {}
    for key, fn in (("kernel", flash_attention), ("plain", attention_reference)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, mask=mask)
        check(out.grad_fn is not None, f"{key} flash_attention recorded no gradient")
        out.backward(dout)
        grads[key] = [out.detach()] + [t.grad for t in leaves]
    err = check_outputs(torch, "flash_attention autograd", grads["kernel"], grads["plain"],
                        ["out", "dq", "dk", "dv"])
    print(f"flash_attention with requires_grad on the card: gradient recorded, max err "
          f"{err:.3e} against the plain backward")


def phase_flagship_step(torch):
    """8(b): one flagship step at full width, S=128, B=16, card vs CPU."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    B = 16
    cfg = apply_overrides(Config(), bench.RNA_RBP_OVERRIDES + [
        f"train.batch_size={B}", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"])
    batch = bench.rna_rbp_batch(cfg, B, np.random.default_rng(5))
    step_card_vs_cpu(torch, f"flagship train step B={B} S=128 (full widths, dropout 0.1)",
                     cfg, batch)


def phase_flagship_path(torch, build):
    """8(c) the rna_rbp train CLI, 8(d) the flagship benchmark; the launch
    counts of both."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.experiments import train as train_cli

    build.LAUNCHES.reset()
    overrides = bench.RNA_RBP_OVERRIDES + ["train.batch_size=256", "train.optim.warmup_steps=5",
                                           "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli.main(["--epochs", "3", *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"flagship train CLI losses {losses}")
    check(losses[-1] < losses[0], f"flagship train CLI: loss did not fall: {losses}")
    print(f"flagship train CLI (full widths, B=256, 3 epochs of 3 steps, S=65/129): "
          f"train_loss {losses}, {cli_s:.1f} s")
    out = bench.main(["--model", "rna_rbp", "--batch", "1024"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench rna_rbp B=1024: step {out['step_ms']} ms, {out['value']} pairs/s, "
          f"{out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU {out['mfu']} of "
          f"{out['peak_bf16_tflops']} TFLOP/s bf16 peak")
    print(f"launches during the flagship phase: {launches}")
    for name in ["cls_attention_fwd", "cls_attention_bwd", "short_attention_out_proj"]:
        check(launches[name] > 0, f"kernel {name} was not launched by the flagship path")
    # the CLI's towers (S = 65 and 129 at B=256) and the bench's (S = 128 at
    # B=1024), 8 heads
    check_attention_path(launches, "flagship", (256, 65, 8), (256, 129, 8), (1024, 128, 8))
    check_saved_raw_path(launches, "flagship", 256, 1024)
    # 8(e): the recompute backward's launches come from the path that runs it
    launches["short_attention_bwd"] = flagship_past_the_rule(torch, build)["short_attention_bwd"]
    phase_flagship_recompute_step(torch)
    return launches


def attention_kernels(*shapes):
    """(must run, must not run): the packed attention's launch counters a
    train path over these (B, S, H) shapes raises, by the JAX package's rule
    (`short_attention.saves_probs`)."""
    from clip_dplm_tpu_torch.ops.short_attention import saves_probs

    modes = {saves_probs(*s) for s in shapes}
    on = (["short_attention_save", "short_attention_bwd_probs"] if True in modes else []) + (
        ["short_attention_bwd"] if False in modes else [])
    off = [k for k in ("short_attention_save", "short_attention_bwd_probs",
                       "short_attention_bwd") if k not in on]
    return on, off


def check_attention_path(launches, what, *shapes):
    on, off = attention_kernels(*shapes)
    for name in on:
        check(launches[name] > 0, f"kernel {name} was not launched by the {what} path")
    for name in off:
        check(launches[name] == 0, f"the {what} path ran {name}, which the mode rule does not "
                                   f"pick at {shapes}")
    print(f"{what} path: packed attention in the rule's mode at {shapes}: {', '.join(on)}")


def flagship_past_the_rule(torch, build):
    """8(e): experiments/bench.py --model rna_rbp at B=2304, S=128, H=8
    (JAX's count a packed attention call: 2304·8·128²·2 = 604 MB, past
    512 MiB): the rule picks recompute, and the path launches the recompute
    backward and neither saved-mode kernel. Returns the launch counts of
    that run alone."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.ops.short_attention import saves_probs

    B, S, H = 2304, 128, 8
    check(not saves_probs(B, S, H), f"the rule saves at B={B} S={S} H={H}")
    lib = build.LIBRARY.get()
    designs = [lib.short_attention_recompute_bwd_calls(i) for i in range(3)]
    build.LAUNCHES.reset()
    out = bench.main(["--model", "rna_rbp", "--batch", str(B)])
    torch.cuda.synchronize()
    counts = build.LAUNCHES.snapshot()
    moved = [lib.short_attention_recompute_bwd_calls(i) - designs[i] for i in range(3)]
    print(f"bench rna_rbp B={B} (604 MB a packed call by JAX's count): step {out['step_ms']} ms, "
          f"{out['value']} pairs/s, MFU {out['mfu']}; recompute backward calls by design "
          f"(one block, head, pair): {moved}")
    check_attention_path(counts, f"flagship B={B}", (B, S, H))
    check(moved[0] == counts["short_attention_bwd"] > 0 and moved[1:] == [0, 0],
          f"flagship B={B}: recompute backward calls by design {moved}, not all one block")
    return counts


def phase_flagship_recompute_step(torch):
    """8(e): one flagship step at full width, S=128, B=16, card vs CPU as
    8(b), with the rule pinned to recompute: the one-block recompute
    backward inside a train step, held to the step check's bound."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.ops import short_attention as sa

    B = 16
    cfg = apply_overrides(Config(), bench.RNA_RBP_OVERRIDES + [
        f"train.batch_size={B}", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"])
    batch = bench.rna_rbp_batch(cfg, B, np.random.default_rng(5))
    rule = sa.saves_probs
    sa.saves_probs = lambda *a: False
    try:
        worst, leaf = step_card_vs_cpu(
            torch, f"flagship train step B={B} S=128 in recompute mode (full widths, dropout 0.1)",
            cfg, batch)
    finally:
        sa.saves_probs = rule
    print(f"8(e) worst leaf in recompute mode: {worst:.3f}x its noise ({leaf}); 8(b)'s in saved "
          f"mode was 1.934x (rbp_proj.layer_scale) in the last accepted smoke (PERF.md)")


def phase_tf_clip_kernels(torch, results):
    """9(a): the tiny-S attention forward and backward and the flash
    backward's two kernels against their plain versions, at the tf_clip
    step's shapes and beside SDPA; the backwards on the plain forward's
    residuals."""
    from clip_dplm_tpu_torch.ops import flash_attention as fa
    from clip_dplm_tpu_torch.ops import tiny_attention as ta
    from clip_dplm_tpu_torch.ops.attention import attention_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    def heads(t, H):
        return t.unflatten(-1, (H, -1)).transpose(1, 2)

    # (B, S, D, H, masked): the perturbation tower, a ragged S=33 (the TPU
    # kernel's sp=48 geometry), the transformer tower's 8 tokens
    for B, S, D, H, masked in ((4096, 10, 512, 8, False), (1000, 33, 512, 8, True),
                               (8192, 8, 512, 8, False)):
        main = B == 4096
        qkv, dout = rnd(B, S, 3 * D), rnd(B, S, D)
        mask = ragged_mask(B, S) if masked else None
        mbytes = B * S if masked else 0
        o = ta.tiny_attention_reference(qkv, H, mask=mask)
        q, k, v = (heads(t, H) for t in qkv.split(D, dim=-1))
        sdpa_mask = mask if masked else torch.ones(B, S, dtype=torch.bool, device=dev)
        shape = f"B={B} S={S} D={D} H={H}" + (" ragged" if masked else "")
        with torch.no_grad():
            # bytes: qkv, mask in, o out; f32 ops: the two (S, S, Dh) products a head
            compare(torch, "tiny_attention_fwd", shape + " (SDPA: no out-projection)",
                    lambda: ta.tiny_attention(qkv, H, mask=mask),
                    lambda: ta.tiny_attention_reference(qkv, H, mask=mask), results,
                    work=(B * S * 4 * D * 2 + mbytes, 4 * B * S * S * D, "f32"),
                    library_fn=sdpa_fn(torch, q, k, v, sdpa_mask) if main else None)
        # bytes: qkv, o, dO, mask in, dqkv out; f32 ops: five (S, S, Dh) products a head
        compare(torch, "tiny_attention_bwd", shape + " (on the plain forward's residuals)",
                lambda: ta.tiny_attention_bwd(dout, qkv, o, H, mask=mask),
                lambda: ta.tiny_attention_bwd_reference(dout, qkv, o, H, mask=mask), results,
                work=(B * S * 8 * D * 2 + mbytes, 10 * B * S * S * D, "f32"),
                library_fn=(sdpa_bwd_fn(torch, q, k, v, sdpa_mask, heads(dout, H))
                            if main else None),
                normalize=True)
    # (B, H, S): the cell tower (one sequence of 4096 cells, a degree-style
    # mask: ~5 % of the cells without neighbours), ESM-2 650M, a ragged tile
    for B, H, S, kind in ((1, 8, 4096, "degree"), (32, 20, 1024, "ragged"),
                          (4, 8, 300, "ragged")):
        Dh, main = 64, kind == "degree"
        q, k, v, dout = (rnd(B, H, S, Dh) for _ in range(4))
        mask = (torch.rand(B, S, generator=g, device=dev) > 0.05 if kind == "degree"
                else ragged_mask(B, S))
        out = attention_reference(q, k, v, mask=mask)
        lse = fa.flash_lse_reference(q, k, mask)
        with torch.no_grad():
            _, lse_k = fa._flash_forward(q, k, v, mask, None)
            if main:  # the forward itself at the cell tower's shape, SDPA beside it
                compare(torch, "flash_attention", f"B={B} H={H} S={S} Dh={Dh} {kind}",
                        lambda: fa.flash_attention(q, k, v, mask=mask),
                        lambda: attention_reference(q, k, v, mask=mask), results,
                        library_fn=sdpa_fn(torch, q, k, v, mask))
        lse_err = check_outputs(torch, f"flash_attention lse B={B} H={H} S={S}", [lse_k],
                                [lse], ["lse"])
        shape = f"B={B} H={H} S={S} Dh={Dh} {kind} (on the plain forward's residuals)"
        n = B * H * S * Dh
        # bytes: q, k, v, dO, lse, delta, mask in; dq (dk, dv) out; ops: the
        # score, dP and dq products (score, dP, dk, dv)
        common = 4 * n * 2 + 2 * B * H * S * 4 + B * S
        sdpa_ms = library_time(torch, sdpa_bwd_fn(torch, q, k, v, mask, dout))
        lib = sdpa_ms if main else None
        args = (q, k, v, mask, out, lse, dout)
        dq_ms = compare(torch, "flash_attention_bwd_dq", shape, lambda: fa.flash_bwd_dq(*args),
                        lambda: fa.flash_bwd_dq_reference(*args), results,
                        work=(common + n * 2, 3 * 2 * B * H * S * S * Dh), library_ms=lib,
                        normalize=True)[0]
        # the kernel's two outputs: dk timed through compare, dv checked beside it
        dkv_ms = compare(torch, "flash_attention_bwd_dkv", f"{shape} dk",
                         lambda: fa.flash_bwd_dkv(*args)[0],
                         lambda: fa.flash_bwd_dkv_reference(*args)[0], results,
                         work=(common + 2 * n * 2, 4 * 2 * B * H * S * S * Dh), library_ms=lib,
                         normalize=True)[0]
        print(f"flash backward B={B} H={H} S={S} Dh={Dh} {kind}: dQ {dq_ms:.4f} + dK/dV "
              f"{dkv_ms:.4f} = {dq_ms + dkv_ms:.4f} ms; SDPA's whole backward {sdpa_ms:.4f} ms "
              f"({(dq_ms + dkv_ms) / sdpa_ms:.2f}x)")
        dv_err = check_outputs(torch, f"flash_attention_bwd_dkv {shape}",
                               [fa.flash_bwd_dkv(*args)[1]],
                               [fa.flash_bwd_dkv_reference(*args)[1]], ["dv"], raw_first=False)
        entry = results["flash_attention_bwd_dkv"]
        entry["max_abs_err"] = max(entry["max_abs_err"], dv_err)
        print(f"kernel flash_attention_bwd_dkv {shape} dv: max_abs_err={dv_err:.3e}")
        print(f"flash_attention lse B={B} H={H} S={S}: max abs err {lse_err:.3e}")


def phase_tf_clip_step(torch):
    """9(b): one tf_clip step at full width, B=256, card vs CPU."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    B = 256
    cfg = apply_overrides(Config(), bench.TF_CLIP_OVERRIDES + [
        f"train.batch_size={B}", "train.optim.schedule=constant",
        "train.optim.learning_rate=1e-3"])
    batch = bench.tf_clip_batch(cfg, B, np.random.default_rng(5))
    step_card_vs_cpu(torch, f"tf_clip train step B={B} (full widths, dropout 0.1)", cfg, batch)


def phase_tf_clip_path(torch, build):
    """9(c) the tf_clip train CLI, 9(d) its benchmark; the launch counts of
    both."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.experiments import train as train_cli

    build.LAUNCHES.reset()
    overrides = bench.TF_CLIP_OVERRIDES + ["train.batch_size=256", "train.optim.warmup_steps=5",
                                           "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli.main(["--epochs", "3", *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"tf_clip train CLI losses {losses}")
    check(losses[-1] < losses[0], f"tf_clip train CLI: loss did not fall: {losses}")
    print(f"tf_clip train CLI (full widths, B=256, 3 epochs of 3 steps): train_loss {losses}, "
          f"{cli_s:.1f} s")
    out = bench.main(["--model", "tf_clip", "--batch", "4096"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench tf_clip B=4096: step {out['step_ms']} ms, {out['value']} cells/s, "
          f"{out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU {out['mfu']} of "
          f"{out['peak_bf16_tflops']} TFLOP/s bf16 peak")
    print(f"launches during the tf_clip phase: {launches}")
    for name in list(TF_CLIP_KERNELS) + ["flash_attention"]:
        check(launches[name] > 0, f"kernel {name} was not launched by the tf_clip path")
    check_saved_raw_path(launches, "tf_clip", 256, 4096)
    return launches


def phase_cache_kernels(torch, results):
    """10(a): the row cross-entropy's three kernels against their plain
    versions at the cached step's shapes (the backward kernels on the plain
    lse), and the whole fused_row_ce at a ragged shape with shuffled labels.
    No single library call computes these functions: library_ms is null."""
    from clip_dplm_tpu_torch.ops import fused_infonce as fi

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)

    def unit(*s):
        return torch.nn.functional.normalize(torch.randn(*s, generator=g, device=dev), dim=-1)

    d = 512
    scale = torch.tensor([14.2857], device=dev)
    # (what, m, n, n_valid, rows of y whose gradient is formed)
    for what, m, n, nv, rows in (("a->[b; cache]", 8192, 16384, 8192 + 5000, 8192),
                                 ("b->a", 8192, 8192, 8192, 8192),
                                 ("ragged", 1000, 1777, 1400, 1777)):
        x, y = unit(m, d), unit(n, d)
        x[: min(m, n)] = torch.nn.functional.normalize(x[: min(m, n)] + y[: min(m, n)], dim=-1)
        xb, yb = x.bfloat16(), y.bfloat16()
        nvt = torch.tensor([nv], dtype=torch.int32, device=dev)
        shape = f"{what} m={m} n={n} n_valid={nv} d={d}"
        lse = fi._plain_row_lse(xb, yb, scale, nvt)
        # bytes: x, the valid rows of y (bf16), scale, n_valid in; lse out
        compare(torch, "row_ce_lse", shape, lambda: fi._kernel_row_lse(xb, yb, scale, nvt),
                lambda: fi._plain_row_lse(xb, yb, scale, nvt), results,
                work=((m + nv) * d * 2 + 8 + m * 4, 2.0 * m * nv * d))
        # bytes: x, y's valid rows, lse in; P y (f32) and rowdot out; ops: the
        # recomputed raw tile and the contraction
        compare(torch, "row_ce_dx", shape + " P y (on the plain lse)",
                lambda: fi._kernel_row_dx(xb, yb, scale, lse, nvt)[0],
                lambda: fi._plain_row_dx(xb, yb, scale, lse, nvt)[0], results,
                work=((m + nv) * d * 2 + m * 4 + m * d * 4 + m * 4, 4.0 * m * nv * d),
                normalize=True)
        rd_err = check_outputs(torch, f"row_ce_dx {shape}",
                               [fi._kernel_row_dx(xb, yb, scale, lse, nvt)[1]],
                               [fi._plain_row_dx(xb, yb, scale, lse, nvt)[1]], ["rowdot"],
                               raw_first=False)
        results["row_ce_dx"]["max_abs_err"] = max(results["row_ce_dx"]["max_abs_err"], rd_err)
        print(f"kernel row_ce_dx {shape} rowdot: max_abs_err={rd_err:.3e}")
        # bytes: x, y's first `rows` rows, lse in; P^T x (f32) out
        compare(torch, "row_ce_dy", shape + f" P^T x for y's first {rows} rows (on the plain lse)",
                lambda: fi._kernel_row_dy(xb, yb, scale, lse, rows),
                lambda: fi._plain_row_dy(xb, yb, scale, lse, rows), results,
                work=((m + rows) * d * 2 + m * 4 + rows * d * 4, 4.0 * m * rows * d),
                normalize=True)
    # the autograd Function at the ragged shape, shuffled labels
    labels = torch.randperm(1400, generator=g, device=dev)[:1000]
    nvt = torch.tensor([1400], dtype=torch.int32, device=dev)
    outs = {}
    for key, fn in (("kernel", fi.fused_row_ce), ("plain", fi.fused_row_ce_reference)):
        leaves = [t.clone().requires_grad_(True) for t in (x, y, scale)]
        loss = fn(*leaves, labels, nvt, torch.bfloat16)
        loss.backward()
        outs[key] = [loss.detach()] + [t.grad for t in leaves]
    err = check_outputs(torch, "fused_row_ce m=1000 n=1777 n_valid=1400 (shuffled labels)",
                        outs["kernel"], outs["plain"], ["loss", "dx", "dy", "dscale"])
    print(f"fused_row_ce m=1000 n=1777 n_valid=1400 shuffled labels, kernels vs plain: "
          f"max err {err:.3e} (loss, dx, dy, dscale)")
    print("row_ce kernels: no single library call computes them (library_ms null)")


def phase_cache_step(torch):
    """10(b): one cached step at the preset's widths, B=256, from a warm
    cache of 1024 rows (640 filled), card vs CPU."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments import bench

    B, C, filled = 256, 1024, 640
    cfg = apply_overrides(Config(), bench.PRESET_OVERRIDES + [
        f"train.batch_size={B}", f"contrastive.cache_size={C}",
        "train.optim.schedule=constant", "train.optim.learning_rate=1e-3"])
    rng = np.random.default_rng(5)
    batch = {"a": rng.normal(size=(B, cfg.tower_a.input_dim)).astype(np.float32),
             "b": rng.normal(size=(B, cfg.tower_b.input_dim)).astype(np.float32)}
    rows = np.zeros((C, cfg.projection.dim), np.float32)
    rows[:filled] = rng.normal(size=(filled, cfg.projection.dim))
    rows[:filled] /= np.linalg.norm(rows[:filled], axis=1, keepdims=True)
    step_card_vs_cpu(torch, f"cached train step B={B} C={C} cache_len={filled} (preset "
                     "widths, dropout 0.1)", cfg, batch, cache=(rows, filled, filled))


def phase_cache_path(torch, build):
    """10(c) the preset's train CLI, 10(d) the cached benchmark; the launch
    counts of both."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.experiments import train as train_cli

    build.LAUNCHES.reset()
    overrides = bench.PRESET_OVERRIDES + ["train.batch_size=128", "train.optim.warmup_steps=5",
                                          "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli.main(["--epochs", "3", *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"preset train CLI losses {losses}")
    check(losses[-1] < losses[0], f"preset train CLI: loss did not fall: {losses}")
    print(f"two_tower_optimized preset train CLI (B=128, cache 8192, 3 epochs of 13 steps): "
          f"train_loss {losses}, val_loss {hist['val_loss']}, {cli_s:.1f} s")
    out = bench.main(["--model", "two_tower_cached", "--batch", "8192"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench two_tower_cached B=8192 (cache 8192, full): step {out['step_ms']} ms, "
          f"{out['value']} pairs/s, {out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU "
          f"{out['mfu']} of {out['peak_bf16_tflops']} TFLOP/s bf16 peak")
    print(f"launches during the cache phase: {launches}")
    for name in CACHE_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the cached path")
    return launches


def phase_saved_raw_kernels(torch, results):
    """11: the saved-raw InfoNCE's four kernels against their plain versions
    (the backward ones on the same raw and the plain lse), bit-for-bit
    repeats, the whole autograd Function, and the two from-raw schedules
    timed at the train paths' shapes."""
    from clip_dplm_tpu_torch.ops import fused_infonce as fi

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)

    def unit(*s):
        return torch.nn.functional.normalize(torch.randn(*s, generator=g, device=dev), dim=-1)

    d = 512
    scale = torch.tensor([14.2857], device=dev)
    # 256 and a ragged 200: one cluster of the merged kernel (no partials),
    # the launch the train CLIs' B=256 steps make
    for what, B in (("two-tower", 8192), ("tf_clip pair", 4096), ("ragged", 1000),
                    ("train CLI", 256), ("ragged one cluster", 200)):
        x = unit(B, d)
        y = torch.nn.functional.normalize(x + 0.5 * unit(B, d), dim=-1)
        xb, yb = x.bfloat16(), y.bfloat16()
        shape = f"{what} B={B} d={d}"
        got, want = fi._kernel_lse_save(xb, yb, scale), fi._plain_lse_save(xb, yb, scale)
        err = max(check_outputs(torch, f"sym_infonce_lse_save {shape}", [got[i]], [want[i]],
                                [name]) for i, name in enumerate(("lse_row", "lse_col")))
        dq = (got[2].int() - want[2].int()).abs().max().item()
        check(got[2].shape == want[2].shape and dq <= 1,
              f"sym_infonce_lse_save {shape}: raw_q off by {dq} (bound 1)")
        print(f"sym_infonce_lse_save {shape}: raw_q max |dq| {dq}, "
              f"{int((got[2] != want[2]).sum())} of {B * B} entries differ by 1")
        ms, plain_ms = timed_pair(torch, lambda: fi._kernel_lse_save(xb, yb, scale),
                                  lambda: fi._plain_lse_save(xb, yb, scale))
        # bytes: x, y (bf16), scale in; both lse and the int16 raw out; ops: the raw product
        record(results, "sym_infonce_lse_save", shape + " (lse and int16 raw)", err, ms, plain_ms,
               work=(2 * B * d * 2 + 4 + 2 * B * 4 + B * B * 2, 2 * B * B * d))
        args = (got[2], xb, yb, scale, *want[:2])
        raw_in = B * B * 2 + 2 * B * 4 + 4  # raw_q, both lse, scale
        passes = (  # name, kernel, plain, outputs, bytes, ops
            ("sym_infonce_grad_raw", fi._kernel_grad_raw, fi._plain_grad_raw,
             ["acc_a", "rowdot"], raw_in + B * d * 2 + B * d * 4 + B * 4, 2 * B * B * d),
            ("sym_infonce_grad_rawT", lambda *a: (fi._kernel_grad_rawT(*a),),
             lambda *a: (fi._plain_grad_rawT(*a),), ["acc_b"], raw_in + B * d * 2 + B * d * 4,
             2 * B * B * d),
            ("sym_infonce_grad_merged", fi._kernel_grad_merged, fi._plain_grad_from_raw,
             ["acc_a", "rowdot", "acc_b"], raw_in + 2 * B * d * 2 + 2 * B * d * 4 + B * 4,
             4 * B * B * d))
        for name, kfn, pfn, outs, nbytes, ops in passes:
            err = check_outputs(torch, f"{name} {shape}", kfn(*args), pfn(*args), outs,
                                raw_first=False)
            ms, plain_ms = timed_pair(torch, lambda: kfn(*args), lambda: pfn(*args))
            record(results, name, f"{shape} {', '.join(outs)} (on the plain lse)", err, ms,
                   plain_ms, work=(nbytes, ops))
        err = check_outputs(torch, f"merged vs two-pass {shape}", fi._kernel_grad_merged(*args),
                            fi._kernel_grad_two_pass(*args), ["acc_a", "rowdot", "acc_b"],
                            raw_first=False)
        print(f"sym_infonce_grad_merged {shape}: against the two passes, max err {err:.3e}")
        for name, fn in (("sym_infonce_lse_save", lambda: fi._kernel_lse_save(xb, yb, scale)),
                         ("sym_infonce_grad_raw", lambda: fi._kernel_grad_raw(*args)),
                         ("sym_infonce_grad_rawT", lambda: (fi._kernel_grad_rawT(*args),)),
                         ("sym_infonce_grad_merged", lambda: fi._kernel_grad_merged(*args))):
            first, second = fn(), fn()
            check(all(torch.equal(u, v) for u, v in zip(first, second)),
                  f"{name} {shape}: two launches differ")
        print(f"saved-raw kernels {shape}: two launches of each equal byte for byte")
    # the whole autograd Function with the saved raw. Its backward is held
    # to the plain backward run on the residuals the kernel forward saved
    # (its raw_q and lse): with aligned pairs (b near a) 0.5 acc_a nearly
    # cancels b in da, so a wrong acc_a or acc_b moves da by many times its
    # largest entry. Two forwards' lse differ by ~1e-5, and where one diagonal
    # p's bf16 rounding flips, a whole row of da moves by ~10 % of that entry:
    # so kernels against plain end to end only on independent unit rows.
    for B, aligned in ((8192, False), (1000, False), (8192, True), (256, True)):
        a = unit(B, d)
        b = torch.nn.functional.normalize(a + 0.5 * unit(B, d), dim=-1) if aligned else unit(B, d)
        outs, graphs = {}, {}
        for key, fn, mat in (("kernel", fi.fused_symmetric_infonce, True),
                             ("plain", fi.fused_symmetric_infonce_reference, True),
                             ("recompute", fi.fused_symmetric_infonce, False)):
            leaves = [t.clone().requires_grad_(True) for t in (a, b, scale)]
            loss = fn(*leaves, torch.bfloat16, materialize_raw=mat)
            loss.backward(retain_graph=True)
            outs[key] = [loss.detach()] + [t.grad for t in leaves]
            graphs[key] = loss
        torch.cuda.synchronize()
        what = f"fused_symmetric_infonce(materialize_raw=True) B={B} d={d}" + (
            " aligned pairs" if aligned else "")
        rel = [_rel(u.float(), v.float()) for u, v in zip(outs["kernel"][1:],
                                                           outs["recompute"][1:])]
        print(f"{what}: loss saved vs recompute {outs['kernel'][0].item():.7f} vs "
              f"{outs['recompute'][0].item():.7f}; gradients saved vs recompute rel L2 "
              f"{', '.join(f'{r:.2e}' for r in rel)} (da, db, dscale)")
        a_, b_, ad, bd, s32, lse_a, lse_b, diag, raw_q = graphs["kernel"].grad_fn.saved_tensors
        check(raw_q.dtype == torch.int16 and raw_q.shape == (B, B),
              f"{what}: the forward saved no int16 raw")
        plain = fi._sym_tail(torch.ones((), device=dev), a_, b_, s32, diag,
                             *fi._plain_grad_from_raw(raw_q, ad, bd, s32, lse_a, lse_b))
        err = check_outputs(torch, f"{what} backward on its saved residuals",
                            outs["kernel"][1:], [plain[0], plain[1], plain[2].reshape(1)],
                            ["da", "db", "dscale"], raw_first=False)
        print(f"{what}, backward kernels vs plain on the saved raw and lse: max err "
              f"{err:.3e} (da, db, dscale)")
        if aligned and B == 8192:
            saved_ms, recompute_ms = timed_pair(
                torch, lambda: graphs["kernel"].backward(retain_graph=True),
                lambda: graphs["recompute"].backward(retain_graph=True))
            print(f"InfoNCE backward B={B} d={d}: from the saved raw {saved_ms:.4f} ms, "
                  f"recompute {recompute_ms:.4f} ms (kernels and tail)")
        if not aligned:
            err = check_outputs(torch, what, outs["kernel"], outs["plain"],
                                ["loss", "da", "db", "dscale"])
            print(f"{what}, kernels vs plain: max err {err:.3e} (loss, da, db, dscale)")
        del graphs
    phase_from_raw_schedules(torch, fi, unit, scale, d)
    print("saved-raw kernels: no single library call computes them (library_ms null)")


def wall_ms(torch, fn, iters: int = 50) -> float:
    """Host-and-device ms per call of fn called back to back: the larger of
    the host's time to issue a call and the device's to run it, what a
    host-bound step pays."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_from_raw_schedules(torch, fi, unit, scale, d):
    """The merged and two-pass from-raw schedules at the train paths' shapes,
    in five alternating rounds (merged, two-pass, two-pass, merged): device
    ms (cuda_ms) and host-and-device ms (wall_ms), beside the port's shape
    rule. Where the device times differ by 1.5x (B=8192, 4096) the rule must
    take the faster."""
    for B in (8192, 4096, 1024, 512, 256, 200, 128):
        x = unit(B, d).bfloat16()
        y = unit(B, d).bfloat16()
        lse_row, lse_col, raw_q = fi._kernel_lse_save(x, y, scale)
        args = (raw_q, x, y, scale, lse_row, lse_col)
        fns = {"merged": lambda: fi._kernel_grad_merged(*args),
               "two-pass": lambda: fi._kernel_grad_two_pass(*args)}
        dev = {k: [] for k in fns}
        wall = {k: [] for k in fns}
        for _ in range(5):
            for k in ("merged", "two-pass", "two-pass", "merged"):
                dev[k].append(cuda_ms(torch, fns[k]))
                wall[k].append(wall_ms(torch, fns[k]))
        pick = "merged" if fi._from_raw_merged(B) else "two-pass"
        med = {k: (float(np.median(dev[k])), float(np.median(wall[k]))) for k in fns}
        print(f"from-raw schedule B={B} d={d}: device ms merged {dev['merged']}, two-pass "
              f"{dev['two-pass']}; host-and-device ms merged {wall['merged']}, two-pass "
              f"{wall['two-pass']}; medians merged {med['merged'][0]:.4f} / "
              f"{med['merged'][1]:.4f}, two-pass {med['two-pass'][0]:.4f} / "
              f"{med['two-pass'][1]:.4f}; the port's rule takes {pick}")
        other = "two-pass" if pick == "merged" else "merged"
        if max(dev[other]) * 1.5 < min(dev[pick]) or max(dev[pick]) * 1.5 < min(dev[other]):
            check(max(dev[pick]) < min(dev[other]),
                  f"from-raw schedule B={B}: the rule takes {pick}, the slower by 1.5x")


def phase_dplm_kernels(torch, results):
    """12(a): the saving forward and the backward from the probabilities
    against their plain versions, on the plain forward's residuals, with the
    recompute backward beside them (held to its plain version at S=255) and
    SDPA's backward, timed only."""
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import short_attention as sa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    def heads(t, H):
        return t.unflatten(-1, (H, -1)).transpose(1, 2)

    # (B, S, D, H, rope): DPLM's bench step, the flagship block, DPLM's CLI
    # (S=64), ragged S=65, S=255 at Dh=64 and Dh=128, and the forward's two
    # blocks a head at Dh=128: S=129 and S=256
    for B, S, D, H, rope in ((256, 128, 640, 10, True), (1024, 128, 512, 8, False),
                             (256, 64, 640, 10, True), (1000, 65, 512, 8, False),
                             (32, 255, 640, 10, True), (32, 255, 1024, 8, True),
                             (32, 129, 1024, 8, True), (32, 256, 1024, 8, False)):
        main = (B, S) == (256, 128)
        qkv, dout, mask = rnd(B, S, 3 * D), rnd(B, S, D), ragged_mask(B, S)
        pos = torch.arange(S, device=dev) if rope else None
        kw = dict(mask=mask, rope_positions=pos)
        o, probs = sa.short_attention_qkv_reference(qkv, H, return_probs=True, **kw)
        q, k, v = (heads(t, H) for t in qkv.split(D, dim=-1))
        shape = f"B={B} S={S} D={D} H={H}" + (" rope" if rope else "")
        with torch.no_grad():
            fwd = lambda: sa.short_attention_qkv_save(qkv, H, **kw)  # noqa: E731
            got, again = fwd(), fwd()
            err = check_outputs(torch, f"short_attention_save {shape}", got, (o, probs),
                                ["o", "probs"])
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"short_attention_save {shape}: two launches differ")
            ms, plain_ms = timed_pair(
                torch, fwd, lambda: sa.short_attention_qkv_reference(qkv, H, return_probs=True,
                                                                     **kw))
        # bytes: qkv, mask, cos/sin in; o and the probabilities out; ops: two
        # (S, S, Dh) products a head
        record(results, "short_attention_save", shape + " (o and bf16 probabilities)", err, ms,
               plain_ms, work=(B * S * 4 * D * 2 + B * H * S * S * 2 + B * S
                               + (S * D // H * 4 if rope else 0),
                               4 * B * S * S * D),
               library_ms=library_time(torch, sdpa_fn(torch, q, k, v, mask)) if main else None)
        sdpa_bwd = sdpa_bwd_fn(torch, q, k, v, mask, heads(dout, H))
        bwd = lambda: sa.short_attention_qkv_bwd_probs(dout, qkv, probs, H,  # noqa: E731
                                                       rope_positions=pos)
        got, again = bwd(), bwd()
        err = check_outputs(torch, f"short_attention_bwd_probs {shape}", [got], [
            sa.short_attention_qkv_bwd_probs_reference(dout, qkv, probs, H, rope_positions=pos)],
            ["dqkv"], raw_first=False)
        check(torch.equal(got, again), f"short_attention_bwd_probs {shape}: two launches differ")
        design = bwd_design(_build.LIBRARY.get(), f"short_attention_bwd_probs {shape}", S,
                            D // H, bwd)
        ms, plain_ms = timed_pair(torch, bwd, lambda: sa.short_attention_qkv_bwd_probs_reference(
            dout, qkv, probs, H, rope_positions=pos))
        # bytes: qkv, dO, the probabilities in; dqkv out; ops: the dP, dQ, dK
        # and dV products
        record(results, "short_attention_bwd_probs",
               shape + f" (on the plain probabilities; {design})", err, ms, plain_ms,
               work=(B * S * 7 * D * 2 + B * H * S * S * 2, 8 * B * S * S * D),
               library_ms=library_time(torch, sdpa_bwd) if main else None)
        rec = lambda: sa.short_attention_qkv_bwd(dout, qkv, o, H, **kw)  # noqa: E731
        if S == 255:
            got, again = rec(), rec()
            r_err = check_outputs(torch, f"short_attention_bwd {shape}", [got],
                                  [sa.short_attention_qkv_bwd_reference(dout, qkv, o, H, **kw)],
                                  ["dqkv"], raw_first=False)
            check(torch.equal(got, again), f"short_attention_bwd {shape}: two launches differ")
            results["short_attention_bwd"]["max_abs_err"] = max(
                results["short_attention_bwd"]["max_abs_err"], r_err)
            print(f"kernel short_attention_bwd {shape}: max_abs_err={r_err:.3e}")
        rec_design = bwd_design(_build.LIBRARY.get(), f"short_attention_bwd {shape}", S, D // H,
                                rec, saved=False)
        rec_ms, sdpa_ms = library_time(torch, rec), library_time(torch, sdpa_bwd)
        print(f"packed attention backward {shape}: from the probabilities {ms:.4f} ms, recompute "
              f"{rec_ms:.4f} ms ({rec_design}), SDPA's backward {sdpa_ms:.4f} ms (timed only)")
        del sdpa_bwd


def _dplm_batch(B, S, seed):
    from clip_dplm_tpu_torch.experiments.registry import motif_proteins

    tokens = motif_proteins(np.random.default_rng(seed), B, S)
    return {"tokens": tokens, "mask": tokens != 1}


def phase_dplm_step(torch):
    """12(b): one DPLM step at full width (640/12/10), B=8, S=64, card vs
    CPU; the corruption is the hash draw of the step's seeds on both."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides

    cfg = apply_overrides(Config(), ["experiment=dplm", "train.batch_size=8",
                                     "train.optim.schedule=constant",
                                     "train.optim.learning_rate=1e-3"])
    step_card_vs_cpu(torch, "DPLM train step B=8 S=64 (640/12/10, hash-drawn corruption)", cfg,
                     _dplm_batch(8, 64, 5))


def phase_dplm_long(torch, build):
    """12(c): one DPLM step at S=300, B=4: the flash path, forward and
    backward."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device

    cfg = apply_overrides(Config(), ["experiment=dplm", "train.batch_size=4"])
    state = create_train_state(build_model(cfg, device="cuda"), cfg)
    build.LAUNCHES.reset()
    state, metrics = make_train_step(cfg)(state, to_device(_dplm_batch(4, 300, 6), "cuda"))
    loss = float(metrics["loss"])
    counts = build.LAUNCHES.snapshot()
    check(np.isfinite(loss), f"DPLM step S=300: loss {loss}")
    for name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        check(counts[name] == 12, f"DPLM step S=300: {name} launched {counts[name]} times")
    print(f"DPLM train step B=4 S=300 (flash path): loss {loss:.4f}, flash forward / dQ / dK-dV "
          "launched 12 times each")


def phase_dplm_path(torch, build):
    """12(d) the DPLM train CLI, 12(e) its benchmark; the launch counts of
    both. The CLI shortens the warmup (5 steps, lr 1e-3): at the default
    1000 its 18 steps would keep the learning rate under 2e-5."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.experiments import train as train_cli

    build.LAUNCHES.reset()
    overrides = ["experiment=dplm", "train.optim.warmup_steps=5", "train.optim.learning_rate=1e-3"]
    t0 = time.perf_counter()
    hist = train_cli.main(["--epochs", "3", *[a for o in overrides for a in ("-o", o)]])
    cli_s = time.perf_counter() - t0
    losses = hist["train_loss"]
    check(all(np.isfinite(losses)) and len(losses) == 3, f"DPLM train CLI losses {losses}")
    check(losses[-1] < losses[0], f"DPLM train CLI: loss did not fall: {losses}")
    print(f"DPLM train CLI (640/12/10, B=128, S=64, 3 epochs of 6 steps): train_loss {losses}, "
          f"val_loss {hist['val_loss']}, {cli_s:.1f} s")
    out = bench.main(["--model", "dplm"])
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"bench dplm B=256 S=128: step {out['step_ms']} ms, {out['value']} seqs/s, "
          f"{out['model_tflops_per_s_per_chip']} model TFLOP/s, MFU {out['mfu']} of "
          f"{out['peak_bf16_tflops']} TFLOP/s bf16 peak")
    print(f"launches during the DPLM phase: {launches}")
    for name in ("short_attention", "short_attention_out_proj", "fused_dense_gemm"):
        check(launches[name] > 0, f"kernel {name} was not launched by the DPLM path")
    check_attention_path(launches, "DPLM", (128, 64, 10), (256, 128, 10))
    return launches


def phase_mode_steps(torch):
    """The flagship and DPLM bench steps in the saved mode (the rule's) and
    with the rule pinned to recompute, in turns saved, recompute, recompute,
    saved: what the mode moves end to end."""
    from clip_dplm_tpu_torch.experiments import bench
    from clip_dplm_tpu_torch.ops import short_attention as sa

    rule = sa.saves_probs
    for model in ("rna_rbp", "dplm"):
        times = {"saved": [], "recompute": []}
        for mode in ("saved", "recompute", "recompute", "saved"):
            sa.saves_probs = rule if mode == "saved" else (lambda *a: False)
            try:
                times[mode].append(bench.main(["--model", model])["step_ms"])
            finally:
                sa.saves_probs = rule
        print(f"bench {model} step ms by the attention's mode, in turns: saved {times['saved']}, "
              f"recompute {times['recompute']}")


def phase_separate_kernels(torch, results):
    """13: the four separate-operand launches against their plain versions,
    on the plain forward's residuals, each timed beside SDPA."""
    from clip_dplm_tpu_torch.models.esm import rotary_embed
    from clip_dplm_tpu_torch.ops import _build
    from clip_dplm_tpu_torch.ops import short_attention as sa
    from clip_dplm_tpu_torch.ops.attention import split_heads

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        lens[0] = S
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    # (B, S, D, H, operands, masked): the flagship's chunk views, DPLM's heads
    # after RoPE, ragged S=65, S=255 at Dh=64 and 128, S=64 with no mask, and
    # the forward's two blocks a head at Dh=128: S=129 and S=256
    for B, S, D, H, operands, masked in (
            (1024, 128, 512, 8, "chunk", True), (256, 128, 640, 10, "rope heads", True),
            (1000, 65, 512, 8, "chunk", True), (32, 255, 640, 10, "chunk", True),
            (32, 255, 1024, 8, "heads", True), (256, 64, 512, 8, "chunk", False),
            (32, 129, 1024, 8, "heads", True), (32, 256, 1024, 8, "chunk", True)):
        q, k, v = rnd(B, S, 3 * D).chunk(3, dim=-1)
        if operands != "chunk":
            q, k, v = (split_heads(t, H) for t in (q, k, v))
        if operands == "rope heads":
            pos = torch.arange(S, device=dev)
            q, k = rotary_embed(q, pos), rotary_embed(k, pos)
        mask = ragged_mask(B, S) if masked else None
        dout = rnd(*q.shape)
        hq, hk, hv, hdo = (t if t.dim() == 4 else split_heads(t, H) for t in (q, k, v, dout))
        sdpa_mask = mask if masked else torch.ones(B, S, dtype=torch.bool, device=dev)
        o, probs = sa.short_attention_sep_reference(q, k, v, H, mask=mask, return_probs=True)
        shape = f"B={B} S={S} D={D} H={H} {operands}" + ("" if masked else " no mask")
        n, n_p = B * S * D * 2, B * H * S * S * 2  # bytes of one operand, of the probabilities
        runs = (  # name, kernel, plain, (bytes, ops), SDPA call
            ("short_attention_sep", lambda: sa.short_attention_sep(q, k, v, H, mask=mask),
             lambda: sa.short_attention_sep_reference(q, k, v, H, mask=mask),
             (4 * n + B * S, 4 * B * S * S * D), sdpa_fn(torch, hq, hk, hv, sdpa_mask)),
            ("short_attention_sep_save",
             lambda: sa.short_attention_sep_save(q, k, v, H, mask=mask),
             lambda: sa.short_attention_sep_reference(q, k, v, H, mask=mask, return_probs=True),
             (4 * n + n_p + B * S, 4 * B * S * S * D), sdpa_fn(torch, hq, hk, hv, sdpa_mask)),
            ("short_attention_sep_bwd",
             lambda: sa.short_attention_sep_bwd(dout, q, k, v, o, H, mask=mask),
             lambda: sa.short_attention_sep_bwd_reference(dout, q, k, v, o, H, mask=mask),
             (8 * n + B * S, 10 * B * S * S * D),
             sdpa_bwd_fn(torch, hq, hk, hv, sdpa_mask, hdo)),
            ("short_attention_sep_bwd_probs",
             lambda: sa.short_attention_sep_bwd_probs(dout, q, k, v, probs, H),
             lambda: sa.short_attention_sep_bwd_probs_reference(dout, q, k, v, probs, H),
             (7 * n + n_p, 8 * B * S * S * D), sdpa_bwd_fn(torch, hq, hk, hv, sdpa_mask, hdo)))
        # bytes: q, k, v (and o, dO, the probabilities where read) in, the
        # outputs once; ops: two (S, S, Dh) products a head forward, five
        # backward in recompute mode, four from the probabilities
        for name, kernel_fn, plain_fn, work, library_fn in runs:
            with torch.no_grad():
                got, again = kernel_fn(), kernel_fn()
                want = plain_fn()
            got, again, want = ([t] if torch.is_tensor(t) else list(t)
                                for t in (got, again, want))
            outs = {"short_attention_sep": ["o"], "short_attention_sep_save": ["o", "probs"]}
            names = outs.get(name, ["dq", "dk", "dv"])
            err = check_outputs(torch, f"{name} {shape}", got, want, names,
                                raw_first=name in outs)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {shape}: two launches differ")
            row = shape
            if name in ("short_attention_sep_bwd_probs", "short_attention_sep_bwd"):
                row += " (" + bwd_design(_build.LIBRARY.get(), f"{name} {shape}", S, D // H,
                                         kernel_fn, saved=name.endswith("probs")) + ")"
            with torch.no_grad():
                ms, plain_ms = timed_pair(torch, kernel_fn, plain_fn)
            lib_ms = library_time(torch, library_fn)
            record(results, name, row, err, ms, plain_ms, work=work, library_ms=lib_ms)
            if B == 1024:  # the chunk views read in place against contiguous heads
                cq, ck, cv, cdo, co = (t.contiguous() for t in (hq, hk, hv, hdo, split_heads(o, H)))
                heads_fn = {
                    "short_attention_sep": lambda: sa.short_attention_sep(cq, ck, cv, H, mask=mask),
                    "short_attention_sep_save": lambda: sa.short_attention_sep_save(
                        cq, ck, cv, H, mask=mask),
                    "short_attention_sep_bwd": lambda: sa.short_attention_sep_bwd(
                        cdo, cq, ck, cv, co, H, mask=mask),
                    "short_attention_sep_bwd_probs": lambda: sa.short_attention_sep_bwd_probs(
                        cdo, cq, ck, cv, probs, H)}[name]
                with torch.no_grad():
                    t_bhsd = min(cuda_ms(torch, heads_fn), cuda_ms(torch, heads_fn))
                print(f"{name} {shape}: (B, S, D) chunk views {ms:.4f} ms, contiguous "
                      f"(B, H, S, Dh) heads {t_bhsd:.4f} ms")
        del runs


def _count_plain_calls_on_the_card(torch):
    """Wrap the separate-operand plain versions and the plain formulation so
    that each call on a CUDA tensor is counted; (counts, restore)."""
    from clip_dplm_tpu_torch.ops import attention as att
    from clip_dplm_tpu_torch.ops import short_attention as sa

    counts = {"plain": 0}
    saved = []
    for mod, name in ((sa, "short_attention_sep_reference"),
                      (sa, "short_attention_sep_bwd_reference"),
                      (sa, "short_attention_sep_bwd_probs_reference"),
                      (att, "attention_reference")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, **k):
            if any(torch.is_tensor(t) and t.is_cuda for t in a):
                counts["plain"] += 1
            return _fn(*a, **k)

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return counts, restore


def phase_separate_path(torch, build):
    """14: the gates' path at full width, and the blocks' two routes.
    Returns the launch counts of (a)."""
    from clip_dplm_tpu_torch.ops import short_attention as sa
    from clip_dplm_tpu_torch.ops.attention import (
        attention_dispatch, attention_reference, multihead_attention, split_heads)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(37)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    sep = list(SEPARATE_KERNELS)
    total = dict.fromkeys(sep, 0)
    # (a) (B, S, D, H): the flagship at B=1024 (saved) and 2304 (past the
    # rule's 512 MiB: recompute), DPLM 640/10 at B=256 (saved)
    for B, S, D, H in ((1024, 128, 512, 8), (2304, 128, 512, 8), (256, 128, 640, 10)):
        save = sa.saves_probs(B, S, H)
        check(save is (B != 2304), f"the rule's mode at B={B} S={S} H={H}: save={save}")
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        mask = torch.arange(S, device=dev)[None, :] < lens[:, None]
        qkv, dout = rnd(B, S, 3 * D), rnd(B, S, D)
        for entry in ("multihead_attention", "attention_dispatch"):
            leaves = [t.clone().requires_grad_(True) for t in qkv.chunk(3, dim=-1)]
            if entry == "attention_dispatch":
                ops = [split_heads(t, H) for t in leaves]
                fn = lambda: attention_dispatch(*ops, mask=mask)  # noqa: E731
                d_o = split_heads(dout, H)
            else:
                fn = lambda: multihead_attention(*leaves, H, mask=mask)  # noqa: E731
                d_o = dout
            counts, restore = _count_plain_calls_on_the_card(torch)
            try:
                build.LAUNCHES.reset()
                out = fn()
                out.backward(d_o)
                torch.cuda.synchronize()
                launches = build.LAUNCHES.snapshot()
            finally:
                restore()
            ran = {k for k, c in launches.items() if c}
            want = ({"short_attention_sep_save", "short_attention_sep_bwd_probs"} if save
                    else {"short_attention_sep", "short_attention_sep_bwd"})
            what = f"{entry} B={B} S={S} D={D} H={H}"
            check(ran == want and all(launches[k] == 1 for k in want),
                  f"{what}: launched {launches} (want one each of {sorted(want)})")
            check(counts["plain"] == 0, f"{what}: {counts['plain']} plain calls on the card")
            for k in sep:
                total[k] += launches[k]
            got = [out.detach()] + [t.grad for t in leaves]
            plain = [t.detach().clone().requires_grad_(True) for t in qkv.chunk(3, dim=-1)]
            ref = attention_reference(*(split_heads(t, H) for t in plain), mask=mask)
            ref = ref if entry == "attention_dispatch" else ref.transpose(1, 2).reshape(B, S, D)
            ref.backward(d_o)
            err = check_outputs(torch, what, got, [ref.detach()] + [t.grad for t in plain],
                                ["out", "dq", "dk", "dv"])
            print(f"{what}: launched {sorted(want)} once each (the rule's "
                  f"{'saved' if save else 'recompute'} mode), no plain call on the card, max "
                  f"err {err:.3e} against the plain formulation")
            del leaves, out, got, plain, ref
    print(f"launches during the gates' path: {total}")
    _block_routes(torch, g)
    return total


def _block_routes(torch, g):
    """14(b) the flagship TransformerBlock's attention, 14(c) one DPLM
    EsmBlock's with RoPE: the packed kernel's route against the separate
    kernels' route on the same weights and inputs."""
    import torch.nn.functional as F

    from clip_dplm_tpu_torch.models.esm import EsmBlock, rotary_embed
    from clip_dplm_tpu_torch.models.layers import TransformerBlock
    from clip_dplm_tpu_torch.ops.attention import (
        attention_dispatch, merge_heads, multihead_attention, packed_qkv_attention_proj,
        split_heads)

    dev = torch.device("cuda")
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def ragged_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        return torch.arange(S, device=dev)[None, :] < lens[:, None]

    def randomize(module):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(rnd(*p.shape).float() * (0.02 if p.dim() == 1 else p.shape[-1] ** -0.5))
        return module

    B, S = 1024, 128
    block = randomize(TransformerBlock(512, 8, dropout=0.0, device=dev))
    mask = ragged_mask(B, S)
    qkv, dy = rnd(B, S, 3 * 512), rnd(B, S, 512)
    routes = {
        "packed": lambda x: packed_qkv_attention_proj(x, block.out_proj.kernel,
                                                      block.out_proj.bias, 8, mask=mask),
        "separate": lambda x: block.out_proj(multihead_attention(*x.chunk(3, dim=-1), 8,
                                                                 mask=mask))}
    res = {}
    for name, route in routes.items():
        block.zero_grad()
        x = qkv.clone().requires_grad_(True)
        y = route(x)
        y.backward(dy)
        res[name] = [y.detach(), x.grad, block.out_proj.kernel.grad.clone(),
                     block.out_proj.bias.grad.clone()]
    err = check_outputs(torch, "flagship block attention, separate vs packed", res["separate"],
                        res["packed"], ["y", "dqkv", "dWo", "dbo"])
    print(f"flagship TransformerBlock attention B={B} S={S}: separate route (multihead_attention"
          f" + out_proj) vs packed route, max err {err:.3e}")

    B, S, D, H = 256, 128, 640, 10
    esm = randomize(EsmBlock(D, H, device=dev))
    mask = ragged_mask(B, S)
    pos = torch.arange(S, device=dev)
    h0, dy = rnd(B, S, D), rnd(B, S, D)

    def packed(h):
        w = torch.cat([esm.q.kernel, esm.k.kernel, esm.v.kernel], 0)
        b = torch.cat([esm.q.bias, esm.k.bias, esm.v.bias])
        return packed_qkv_attention_proj(F.linear(h, w.to(h.dtype), b.to(h.dtype)),
                                         esm.out.kernel, esm.out.bias, H, mask=mask,
                                         rope_positions=pos)

    def separate(h):
        qh = rotary_embed(split_heads(esm.q(h), H), pos)
        kh = rotary_embed(split_heads(esm.k(h), H), pos)
        vh = split_heads(esm.v(h), H)
        return esm.out(merge_heads(attention_dispatch(qh, kh, vh, mask=mask)))

    params = [esm.q, esm.k, esm.v, esm.out]
    res = {}
    for name, route in (("packed", packed), ("separate", separate)):
        esm.zero_grad()
        h = h0.clone().requires_grad_(True)
        y = route(h)
        y.backward(dy)
        res[name] = [y.detach(), h.grad] + [t.grad.clone() for m in params
                                            for t in (m.kernel, m.bias)]
    names = ["y", "dh"] + [f"d{m}.{t}" for m in ("q", "k", "v", "out") for t in ("kernel", "bias")]
    err = check_outputs(torch, "DPLM EsmBlock attention, separate vs packed", res["separate"],
                        res["packed"], names)
    print(f"DPLM EsmBlock attention B={B} S={S} D={D} H={H} with RoPE: separate route "
          f"(rotary_embed + attention_dispatch + out) vs the packed RoPE kernel, max err "
          f"{err:.3e}")


def kernel_registers(log: str, kernel: str):
    """(instance, registers, spill line) of each instance of `kernel` in
    ptxas's report: its template arguments, as <a, b, ...>."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        found = re.search(kernel + r"((?:IL[ib]\d+E|L[ib]\d+E)*)", line)
        if "Compiling entry" in line and found:
            regs = re.search(r"Used (\d+) registers", " ".join(lines[i:i + 4]))
            spill = next((x.strip() for x in lines[i:i + 4] if "spill" in x), "spills: not reported")
            args = ", ".join(re.findall(r"L[ib](\d+)E", found.group(1)))
            yield f"<{args}>", regs.group(1) if regs else "?", spill


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from clip_dplm_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.LIBRARY.get()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.LIBRARY.build_seconds:.1f} s) "
          f"-> {_build.LIBRARY.path}")
    for line in _build.LIBRARY.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print("ptxas:", line.strip())
    for what, kernel in (("GEMM", "dense_gemm_kernel"),
                         ("short-S forward", "short_attn_fwd_kernel"),
                         ("short-S backward, one block a head",
                          "short_attn_bwd_block_kernel"),
                         ("flash backward dQ", "flash_bwd_dq_kernel"),
                         ("flash backward dK/dV", "flash_bwd_dkv_kernel")):
        for args, regs, spills in kernel_registers(_build.LIBRARY.build_log, kernel):
            print(f"{what} {kernel}{args}: {regs} registers, {spills}")

    results = {}
    phase_kernels(torch, results)
    phase_model(torch)
    launches = phase_server(torch, _build)
    phase_train_kernels(torch, results)
    phase_train_step(torch, _build)
    # the saved-raw kernels' launches: their sum over the three train paths
    saved = dict.fromkeys(SAVED_RAW_KERNELS, 0)

    def keep(counts, names):
        launches.update({k: v for k, v in counts.items() if k in names})
        for k in saved:
            saved[k] += counts[k]

    keep(phase_train_path(torch, _build), TRAIN_KERNELS)
    phase_flagship_kernels(torch, results)
    phase_flagship_step(torch)
    keep(phase_flagship_path(torch, _build), FLAGSHIP_KERNELS)
    phase_tf_clip_kernels(torch, results)
    phase_tf_clip_step(torch)
    keep(phase_tf_clip_path(torch, _build), TF_CLIP_KERNELS)
    phase_cache_kernels(torch, results)
    phase_cache_step(torch)
    launches.update({k: v for k, v in phase_cache_path(torch, _build).items()
                     if k in CACHE_KERNELS})
    phase_saved_raw_kernels(torch, results)
    launches.update(saved)
    phase_dplm_kernels(torch, results)
    phase_dplm_step(torch)
    phase_dplm_long(torch, _build)
    launches.update({k: v for k, v in phase_dplm_path(torch, _build).items()
                     if k in DPLM_KERNELS})
    phase_mode_steps(torch)
    phase_separate_kernels(torch, results)
    launches.update(phase_separate_path(torch, _build))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **{k: results[name][k] for k in keys}}
        for name, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
