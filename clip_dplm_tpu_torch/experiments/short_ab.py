"""The short-S attention forward of this checkout against another
checkout's, in turns on one card, with SDPA and the bound beside them:

    python -m clip_dplm_tpu_torch.experiments.short_ab --other DIR [--rounds N]

DIR is another checkout of the repository (for example a parent commit
unpacked with `git archive` into a directory that `.gitignore` lists). Its
`clip_dplm_tpu_torch/csrc/short_attention.cu` is compiled alone with nvcc
into `build/short_ab/`, and both checkouts' C entries
(`short_attention_qkv_fwd` for the packed qkv with RoPE,
`short_attention_sep_fwd` and `short_attention_sep_fwd_save` for separate
operands) are called through ctypes on the same inputs, so that both time
the kernel alone (the wrappers' RoPE tables and mask are made once). Both
are held against the plain version (o at atol = rtol = 2e-2, the
probabilities at atol 1e-2, bf16) and timed in turns other, this, this,
other, `--rounds` times, at:

- the flagship's separate operands (B=1024, S=128, D=512, H=8, the
  `qkv.chunk(3, -1)` views), without and with the probabilities;
- DPLM training's packed saving forward (B=256, S=128, D=640, H=10, RoPE);
- the DPLM sampler's packed forward (B=32, S=128, D=640, H=10, RoPE);
- past one block a head, where the scores are recomputed: S=256 at Dh=128
  (B=64, D=1024, H=8, separate) in both modes, and S=200 at Dh=64 (B=64,
  DPLM's widths, packed, saving).

One JSON line per shape, each with SDPA's forward time (timed only) and the
bound: the larger of the bytes the call must move over 3.35 TB/s and its
operations over 989 TFLOP/s.

With `--bwd` it times the backward from the saved probabilities instead:
both checkouts' `short_attention_qkv_bwd_probs` (packed qkv) and
`short_attention_sep_bwd_probs` (separate operands), on the plain forward's
bf16 probabilities and a random dO, held against the plain version
(gradients divided by their largest entry, atol = rtol = 2e-2) and timed in
turns other, this, this, other, at DPLM training's packed shape (B=256,
S=128, D=640, H=10, RoPE), the flagship's separate chunk views and its
packed call (B=1024, S=128, D=512, H=8), S=65 (B=1000, separate: rows of
the probabilities off 16 bytes, which TMA cannot map) and S=200 (B=64,
DPLM's widths, packed, RoPE), past this checkout's one-block bound. Each line names the
design this checkout's launcher picks, with SDPA's whole backward (one
autograd call, timed only) and the bound (qkv, dO and the probabilities
read once, dq, dk, dv written once; four (S, S, Dh) products a head).
`--steps dplm,rna_rbp` then runs each checkout's `experiments/bench.py
--model M` in a process of its own in turns other, this, this, other, and
`--profile dplm` each checkout's `experiments/profile_step.py --model M`
once, printing the device ms a step of its short-S attention kernels.

    python -m clip_dplm_tpu_torch.experiments.short_ab --other DIR --bwd
        [--steps dplm,rna_rbp] [--profile dplm]

Needs a CUDA device and nvcc.
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

from clip_dplm_tpu_torch.experiments.flash_ab import cuda_ms, ptxas_lines
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import short_attention as sa

REPO = Path(__file__).resolve().parents[2]
PEAK_BF16 = 989e12  # H100 SXM dense bf16
HBM_BYTES_PER_S = 3.35e12
TOL = dict(atol=2e-2, rtol=2e-2)
# name, B, S, D, H, entry ("packed" with RoPE or "sep" chunk views), saves probabilities
SHAPES = (
    ("flagship separate", 1024, 128, 512, 8, "sep", False),
    ("flagship separate, saving", 1024, 128, 512, 8, "sep", True),
    ("DPLM packed, saving", 256, 128, 640, 10, "packed", True),
    ("sampler packed", 32, 128, 640, 10, "packed", False),
    ("S=256 Dh=128 separate", 64, 256, 1024, 8, "sep", False),
    ("S=256 Dh=128 separate, saving", 64, 256, 1024, 8, "sep", True),
    ("S=200 Dh=64 packed, saving", 64, 200, 640, 10, "packed", True),
)
FWD_KEYS = ("short_attn_kernel", "short_attn_fwd")  # the forward's mangled names
BWD_KEYS = ("short_attn_bwd_saved", "short_attn_bwd_dq", "short_attn_bwd_dkv")
# name, B, S, D, H, entry ("packed" qkv, RoPE or not, or "sep" chunk views)
BWD_SHAPES = (
    ("DPLM packed, RoPE", 256, 128, 640, 10, "packed rope"),
    ("flagship separate", 1024, 128, 512, 8, "sep"),
    ("flagship packed", 1024, 128, 512, 8, "packed"),
    ("S=65 separate (the probabilities by element loads)", 1000, 65, 512, 8, "sep"),
    ("S=200 packed, RoPE", 64, 200, 640, 10, "packed rope"),
)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ("short_attention_qkv_fwd", "short_attention_sep_fwd",
                 "short_attention_sep_fwd_save", "short_attention_qkv_bwd_probs",
                 "short_attention_sep_bwd_probs"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def build_other(other: Path) -> ctypes.CDLL:
    """The other checkout's short_attention.cu, alone, as a shared library."""
    csrc = other / "clip_dplm_tpu_torch" / "csrc"
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cu*"))))
    out = REPO / "build" / "short_ab" / f"libshort_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
               str(csrc / "short_attention.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        for key in FWD_KEYS + BWD_KEYS:
            for line in ptxas_lines(proc.stdout + proc.stderr, key):
                print("other ptxas:", line)
    return _bind(ctypes.CDLL(str(out)))


def _operand(t: torch.Tensor) -> _build.Operand:
    return _build.Operand(t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def kernel_turns(lib_this: ctypes.CDLL, lib_other: ctypes.CDLL, rounds: int) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    for name, B, S, D, H, entry, save in SHAPES:
        Dh = D // H
        g = torch.Generator(device="cuda").manual_seed(0)
        qkv = torch.randn(B, S, 3 * D, generator=g, device="cuda").bfloat16()
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device="cuda")
        lens[0] = S
        mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
        mask_u8 = mask.to(torch.uint8).contiguous()
        scale = 1.0 / Dh ** 0.5
        out = {t: torch.empty(B, S, D, dtype=torch.bfloat16, device="cuda")
               for t in ("this", "other")}
        probs = {t: torch.empty(B, H, S, S, dtype=torch.bfloat16, device="cuda")
                 if save else None for t in ("this", "other")}
        q, k, v = (sa._sep_heads(t, H) for t in qkv.chunk(3, dim=-1))
        if entry == "packed":
            pos = torch.arange(S, device="cuda")
            cos, sin = (t.contiguous() for t in sa._rope_cos_sin(pos, Dh))
            o_ref, p_ref = sa.short_attention_qkv_reference(qkv, H, mask=mask,
                                                            rope_positions=pos,
                                                            return_probs=True)
            qh, kh, vh, _ = sa._heads_rotated(qkv, H, pos)

            def call(lib, tree):
                p = probs[tree]
                return lib.short_attention_qkv_fwd(
                    qkv.data_ptr(), mask_u8.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                    out[tree].data_ptr(), None if p is None else p.data_ptr(), B, S, H, Dh,
                    scale, stream)
        else:
            o_ref, p_ref = sa.short_attention_sep_reference(q, k, v, H, mask=mask,
                                                            return_probs=True)
            o_ref = sa.merge_heads(o_ref)
            qh, kh, vh = q, k, v
            ops = [_operand(t) for t in (q, k, v)]

            def call(lib, tree):
                o_op = _operand(sa._sep_heads(out[tree], H))
                args = [ctypes.byref(x) for x in ops] + [mask_u8.data_ptr(), ctypes.byref(o_op)]
                if save:
                    return lib.short_attention_sep_fwd_save(*args, probs[tree].data_ptr(), B, S,
                                                            H, Dh, scale, stream)
                return lib.short_attention_sep_fwd(*args, B, S, H, Dh, scale, stream)

        fns = {}
        for tree, lib in (("this", lib_this), ("other", lib_other)):
            def fn(lib=lib, tree=tree):
                rc = call(lib, tree)
                if rc != 0:
                    raise RuntimeError(f"{tree} {name}: CUDA error {rc}")
            fns[tree] = fn
        errs = {}
        for tree in ("this", "other"):
            fns[tree]()
            torch.cuda.synchronize()
            got = out[tree].float()
            ok = bool(torch.isfinite(got).all()) and torch.allclose(got, o_ref.float(), **TOL)
            if save:
                ok = ok and torch.allclose(probs[tree].float(), p_ref.float(), atol=1e-2, rtol=0)
            if not ok:
                raise RuntimeError(f"{tree} forward disagrees with the plain version at {name}")
            errs[tree] = (got - o_ref.float()).abs().max().item()
        times = {"this": [], "other": []}
        for _ in range(rounds):
            for tree in ("other", "this", "this", "other"):
                times[tree].append(cuda_ms(fns[tree]))
        m = mask[:, None, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=m)
        sdpa_ms = min(cuda_ms(sdpa), cuda_ms(sdpa))
        ops_n = 4 * B * S * S * D
        nbytes = 4 * B * S * D * 2 + B * S + (B * H * S * S * 2 if save else 0) + (
            S * Dh * 4 if entry == "packed" else 0)
        bound = max(ops_n / PEAK_BF16, nbytes / HBM_BYTES_PER_S) * 1e3
        print(json.dumps({
            "shape": name, "B": B, "S": S, "D": D, "H": H, "this_ms": times["this"],
            "other_ms": times["other"], "sdpa_ms": sdpa_ms, "bound_ms": bound,
            "this_over_bound": min(times["this"]) / bound, "max_abs_err": errs}))


def _close(got, want) -> float:
    """Max error of got against want over want's largest entry; raises past
    atol = rtol = 2e-2."""
    scale = max(want.abs().max().item(), 1e-30)
    a, b = got.float() / scale, want.float() / scale
    if not (torch.isfinite(a).all() and torch.allclose(a, b, **TOL)):
        raise RuntimeError(f"max error {(a - b).abs().max().item()} past atol = rtol = 2e-2")
    return (a - b).abs().max().item()


def bwd_turns(lib_this: ctypes.CDLL, lib_other: ctypes.CDLL, rounds: int) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    for name, B, S, D, H, entry in BWD_SHAPES:
        Dh = D // H
        g = torch.Generator(device="cuda").manual_seed(0)
        qkv = torch.randn(B, S, 3 * D, generator=g, device="cuda").bfloat16()
        dout = torch.randn(B, S, D, generator=g, device="cuda").bfloat16()
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device="cuda")
        lens[0] = S
        mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
        scale = 1.0 / Dh ** 0.5
        stats = torch.empty(B, H, 3, S, dtype=torch.float32, device="cuda")
        out = {t: torch.empty(B, S, 3 * D, dtype=torch.bfloat16, device="cuda")
               for t in ("this", "other")}
        q, k, v = (sa._sep_heads(t, H) for t in qkv.chunk(3, dim=-1))
        if entry.startswith("packed"):
            pos = torch.arange(S, device="cuda") if entry == "packed rope" else None
            _, probs = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos,
                                                        return_probs=True)
            want = sa.short_attention_qkv_bwd_probs_reference(dout, qkv, probs, H,
                                                              rope_positions=pos)
            cos, sin = ((t.contiguous() for t in sa._rope_cos_sin(pos, Dh)) if pos is not None
                        else (None, None))

            def call(lib, tree):
                return lib.short_attention_qkv_bwd_probs(
                    qkv.data_ptr(), sa._ptr(cos), sa._ptr(sin), probs.data_ptr(),
                    dout.data_ptr(), stats.data_ptr(), out[tree].data_ptr(), B, S, H, Dh, scale,
                    stream)
        else:
            _, probs = sa.short_attention_sep_reference(q, k, v, H, mask=mask, return_probs=True)
            want = torch.cat(sa.short_attention_sep_bwd_probs_reference(
                dout, *qkv.chunk(3, dim=-1), probs, H), dim=-1)
            ops = [_operand(t) for t in (q, k, v, sa._sep_heads(dout, H))]

            def call(lib, tree):
                grads = [_operand(sa._sep_heads(t, H)) for t in out[tree].chunk(3, dim=-1)]
                return lib.short_attention_sep_bwd_probs(
                    *[ctypes.byref(x) for x in ops[:3]], probs.data_ptr(), ctypes.byref(ops[3]),
                    stats.data_ptr(), *[ctypes.byref(x) for x in grads], B, S, H, Dh, scale,
                    stream)

        fns = {}
        for tree, lib in (("this", lib_this), ("other", lib_other)):
            def fn(lib=lib, tree=tree):
                rc = call(lib, tree)
                if rc != 0:
                    raise RuntimeError(f"{tree} {name}: CUDA error {rc}")
            fns[tree] = fn
        errs = {}
        for tree in ("this", "other"):
            fns[tree]()
            torch.cuda.synchronize()
            errs[tree] = max(_close(a, b) for a, b in zip(out[tree].chunk(3, dim=-1),
                                                          want.chunk(3, dim=-1)))
        times = {"this": [], "other": []}
        for _ in range(rounds):
            for tree in ("other", "this", "this", "other"):
                times[tree].append(cuda_ms(fns[tree]))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask[:, None, None, :])
        do_h = sa._sep_heads(dout, H)
        sdpa = lambda: torch.autograd.grad(o, leaves, do_h, retain_graph=True)  # noqa: E731
        sdpa_ms = min(cuda_ms(sdpa), cuda_ms(sdpa))
        ops_n = 8 * B * S * S * D
        nbytes = 7 * B * S * D * 2 + B * H * S * S * 2 + (S * Dh * 4 if entry == "packed rope"
                                                          else 0)
        t_ops, t_bytes = ops_n / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "shape": name, "B": B, "S": S, "D": D, "H": H,
            "design": sa.bwd_saved_design(S, Dh), "this_ms": times["this"],
            "other_ms": times["other"], "sdpa_bwd_ms": sdpa_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "this_over_bound": min(times["this"]) / max(t_ops, t_bytes),
            "this_over_sdpa": min(times["this"]) / sdpa_ms, "max_abs_err": errs}), flush=True)
        del sdpa, o, leaves


def profile_attention(other: Path, model: str) -> None:
    """Each tree's profile_step: the device ms a step of its short-S
    attention kernels."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import _run

    for tree in ("other", "this"):
        lines = [json.loads(x) for x in _run(REPO if tree == "this" else other, "profile_step",
                                             ["--model", model]).splitlines()
                 if x.startswith("{")]
        att = [x for x in lines if "short_attn" in x.get("kernel", "")]
        print(json.dumps({
            "profile": model, "tree": tree,
            "attention_device_ms_per_step": sum(x["device_ms_per_step"] for x in att),
            "attention_launches_per_step": sum(x["launches_per_step"] for x in att),
            "kernels": {x["kernel"][:90]: x["device_ms_per_step"] for x in att},
            "summary": lines[-1]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--bwd", action="store_true",
                    help="the backward from the saved probabilities, not the forward")
    ap.add_argument("--steps", default="", help="bench models to time in turns, comma-separated")
    ap.add_argument("--profile", default="", help="a bench model to profile in each tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("short_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    other = args.other.resolve()
    lib_this = _bind(_build.LIBRARY.get())
    for key in BWD_KEYS if args.bwd else FWD_KEYS:
        for line in ptxas_lines(_build.LIBRARY.build_log, key):
            print("this ptxas:", line)
    turns = bwd_turns if args.bwd else kernel_turns
    turns(lib_this, build_other(other), args.rounds)
    if args.steps:
        from clip_dplm_tpu_torch.experiments.gemm_ab import step_turns

        step_turns(other, args.steps.split(","))
    if args.profile:
        profile_attention(other, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
