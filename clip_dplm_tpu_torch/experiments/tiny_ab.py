"""The tiny-S attention pair (csrc/tiny_attention.cu: `tiny_attention_fwd`
and `tiny_attention_bwd`) of this checkout against another checkout's, in
turns on one card, with the bound beside them:

    python -m clip_dplm_tpu_torch.experiments.tiny_ab --other DIR [--rounds N]
        [--variant NAME] [--steps MODEL,...] [--profile MODEL,...]

DIR is another checkout of the repository (for example a parent commit
unpacked with `git archive` into a directory that `.gitignore` lists), or a
directory under `build/` holding only
`clip_dplm_tpu_torch/csrc/{tiny_attention.cu,common.cuh,tma.cuh,wgmma.cuh}`.
Its `tiny_attention.cu` is compiled alone with nvcc into `build/tiny_ab/`;
this checkout's comes from the package's library. Both trees' C entries are
called through ctypes on the same inputs at `chip_smoke.py`'s phase-9a
shapes (B=4096 S=10, a ragged B=1000 S=33 with one sample whose keys are
all masked, B=8192 S=8; D=512, H=8): the forward on qkv and the mask, the
backward on the plain forward's o and a random dO. Both are held to the
plain versions (`tiny_attention_reference`, `tiny_attention_bwd_reference`;
atol = rtol = 2e-2, the backward divided by its largest entry first) and
timed in turns other, this, this, other, `--rounds` times.

`--variant NAME` builds the other tree with one of its ablations
(`VARIANTS`: `copy` moves the bytes and computes nothing, the floor the
copies set; `nosplit` forms dV from bf16(prob) alone), timed without the
check: `--other . --variant copy` is this checkout's copy skeleton.

One JSON line a shape and direction: both trees' times, the bound (the
larger of the bytes the call must move over 3.35 TB/s and its products over
the peak of their input type: 989 TFLOP/s bf16, 67 TFLOP/s f32 for dV),
each time over it, and the registers and spills ptxas gave the instance
each tree launches there (also printed first, one line an instance).

`--steps tf_clip` then runs each checkout's `experiments/bench.py --model M`
in processes of their own, in turns other, this, this, other, `--rounds`
times, and `--profile tf_clip` each checkout's `experiments/profile_step.py
--model M` in a process of its own (torch.profiler shows kernels only in a
process's first session), printing the device ms a step of the two tiny
kernels beside the step's busy time. Needs a CUDA device and nvcc.
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
from clip_dplm_tpu_torch.ops import tiny_attention as ta

REPO = Path(__file__).resolve().parents[2]
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # H100 SXM: dense bf16; f32 off the tensor cores
TOL = dict(atol=2e-2, rtol=2e-2)
# chip_smoke.py's TINY_SHAPES: (B, S, D, H, masked)
SHAPES = ((4096, 10, 512, 8, False), (1000, 33, 512, 8, True), (8192, 8, 512, 8, False))
ENTRIES = ("tiny_attention_fwd", "tiny_attention_bwd")
KERNELS = ("tiny_attn_fwd_kernel", "tiny_attn_bwd_kernel")
# ablations of csrc/tiny_attention.cu, built with -DTINY_ABLATE=<value>
VARIANTS = {"copy": 1, "nosplit": 2}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="build the other tree with this ablation and time it unchecked")
    ap.add_argument("--steps", default="", help="bench models to time in turns, comma-separated")
    ap.add_argument("--profile", default="",
                    help="bench models to profile in each tree, comma-separated")
    return ap.parse_args(argv)


def work(entry: str, B: int, S: int, D: int, masked: bool):
    """(bytes, operations by input type) the call must move and do. Forward:
    qkv and the mask in, o out; s = q·k^T and p·V, each 2·S²·Dh a head, on
    bf16 inputs. Backward: qkv, o, dO and the mask in, dqkv out; s, dp, dQ
    and dK on bf16 inputs, dV from the f32 probabilities."""
    mask = B * S if masked else 0
    pair = 2 * B * S * S * D  # one (S, S, Dh) product over all heads
    if entry == "tiny_attention_fwd":
        return B * S * 3 * D * 2 + mask + B * S * D * 2, {"bf16": 2 * pair}
    return (B * S * 3 * D * 2 + 2 * B * S * D * 2 + mask + B * S * 3 * D * 2,
            {"bf16": 4 * pair, "f32": pair})


def bound(nbytes: float, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the peak of their type (summed over the types)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(log: str, key: str):
    """{"instance", "registers", "stack_frame", "spill_stores", "spill_loads"}
    (the last three in bytes) of each kernel whose mangled name holds `key`,
    its template arguments as <a, b> ("<>" for a kernel that is no
    template), from nvcc's -Xptxas=-v report."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        found = re.search(key + r"(I(?:L[ib]\d+E)+E)?", line)
        if "Compiling entry" not in line or not found:
            continue
        near = " ".join(lines[i:i + 4])
        regs = re.search(r"Used (\d+) registers", near)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", near)
        yield {"instance": "<" + ", ".join(re.findall(r"L[ib](\d+)E", found.group(1) or "")) + ">",
               "registers": int(regs.group(1)) if regs else None,
               **{k: int(spill.group(i + 1)) if spill else None
                  for i, k in enumerate(("stack_frame", "spill_stores", "spill_loads"))}}


def instance_of(summary, S: int):
    """The entry of `summary` (one kernel's) for the instance launched at S:
    <(S + 15) / 16>, or the one instance of a kernel that is no template."""
    want = f"<{(S + 15) // 16}>"
    return next((x for x in summary if x["instance"] in (want, "<>")), None)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def build_other(other: Path, variant=None):
    """The other checkout's tiny_attention.cu, alone, as a shared library
    (with -DTINY_ABLATE for a variant), and ptxas's report of its kernels."""
    csrc = other / "clip_dplm_tpu_torch" / "csrc"
    defines = [f"-DTINY_ABLATE={VARIANTS[variant]}"] if variant else []
    digest = hashlib.sha256(" ".join(defines).encode())
    for p in sorted(csrc.glob("*.cu*")):
        digest.update(p.read_bytes())
    out = REPO / "build" / "tiny_ab" / f"libtiny_{digest.hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o", str(out),
           str(csrc / "tiny_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return _bind(ctypes.CDLL(str(out))), proc.stdout + proc.stderr


def inputs(B: int, S: int, D: int, masked: bool, seed: int = 21):
    """qkv and dO in bf16; a ragged key mask (sample 0 whole, sample 1 with
    every key masked) or None; the plain forward's o."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, S, 3 * D, generator=g, device="cuda").bfloat16()
    dout = torch.randn(B, S, D, generator=g, device="cuda").bfloat16()
    mask = None
    if masked:
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device="cuda")
        lens[0], lens[1] = S, 0
        mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
    return qkv, dout, mask


def _err(got: torch.Tensor, want: torch.Tensor, what: str, normalize: bool) -> float:
    got, want = got.float(), want.float()
    scale = max(want.abs().max().item(), 1e-30) if normalize else 1.0
    if not (torch.isfinite(got).all() and torch.allclose(got / scale, want / scale, **TOL)):
        raise RuntimeError(f"{what} disagrees with the plain version")
    return (got - want).abs().max().item() / scale


def kernel_turns(lib_this, lib_other, ptx, rounds: int, variant=None) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    for B, S, D, H, masked in SHAPES:
        qkv, dout, mask = inputs(B, S, D, masked)
        m8 = None if mask is None else mask.to(torch.uint8).contiguous()
        mptr = 0 if m8 is None else m8.data_ptr()
        Dh, scale = D // H, (D // H) ** -0.5
        o_ref = ta.tiny_attention_reference(qkv, H, mask=mask)
        want = {"tiny_attention_fwd": o_ref,
                "tiny_attention_bwd": ta.tiny_attention_bwd_reference(dout, qkv, o_ref, H,
                                                                      mask=mask)}
        out = {(tree, e): torch.empty_like(qkv if e == "tiny_attention_bwd" else dout)
               for tree in ("this", "other") for e in ENTRIES}

        def call(lib, tree, entry):
            y = out[(tree, entry)]
            if entry == "tiny_attention_fwd":
                rc = lib.tiny_attention_fwd(qkv.data_ptr(), mptr, y.data_ptr(), B, S, H, Dh,
                                            scale, stream)
            else:
                rc = lib.tiny_attention_bwd(qkv.data_ptr(), mptr, o_ref.data_ptr(),
                                            dout.data_ptr(), y.data_ptr(), B, S, H, Dh, scale,
                                            stream)
            if rc != 0:
                raise RuntimeError(f"{tree} {entry} B={B} S={S}: CUDA error {rc}")

        for entry, kernel in zip(ENTRIES, KERNELS):
            fns = {tree: (lambda lib=lib, tree=tree: call(lib, tree, entry))
                   for tree, lib in (("this", lib_this), ("other", lib_other))}
            errs = {}
            for tree in ("this",) if variant else ("this", "other"):
                fns[tree]()
                torch.cuda.synchronize()
                errs[tree] = _err(out[(tree, entry)], want[entry], f"{tree} {entry} B={B} S={S}",
                                  entry == "tiny_attention_bwd")
            times = {"this": [], "other": []}
            for _ in range(rounds):
                for tree in ("other", "this", "this", "other"):
                    times[tree].append(cuda_ms(fns[tree]))
            bound_ms, bound_by = bound(*work(entry, B, S, D, masked))
            print(json.dumps({
                "kernel": entry, "B": B, "S": S, "D": D, "H": H, "masked": masked,
                "this_ms": times["this"], "other_ms": times["other"], "bound_ms": bound_ms,
                "bound_by": bound_by, "this_over_bound": min(times["this"]) / bound_ms,
                "other_over_bound": min(times["other"]) / bound_ms, "other_is_variant": variant,
                "speedup": min(times["other"]) / min(times["this"]), "max_err": errs,
                "ptxas": {tree: instance_of(ptx[tree][kernel], S) for tree in ptx}}), flush=True)


def profile_tiny(other: Path, model: str) -> None:
    """Each tree's profile_step, in a process of its own: the device ms a
    step of its two tiny kernels, and the step's summary."""
    from clip_dplm_tpu_torch.experiments.gemm_ab import _run

    for tree in ("other", "this"):
        lines = [json.loads(x) for x in _run(REPO if tree == "this" else other, "profile_step",
                                             ["--model", model, "--kernels",
                                              ",".join(KERNELS)]).splitlines()
                 if x.startswith("{")]
        ours = [x for x in lines if any(k in x.get("kernel", "") for k in KERNELS)]
        print(json.dumps({
            "profile": model, "tree": tree,
            "tiny_device_ms_per_step": sum(x["device_ms_per_step"] for x in ours),
            "tiny_launches_per_step": sum(x["launches_per_step"] for x in ours),
            "kernels": {x["kernel"][:90]: x["device_ms_per_step"] for x in ours},
            "summary": lines[-1]}), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("tiny_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    lib_this = _bind(_build.LIBRARY.get())
    this_log = build_other(REPO)[1]  # ptxas's report, whether or not the library was cached
    other = args.other.resolve()
    lib_other, other_log = build_other(other, args.variant)
    ptx = {}
    for tree, log in (("this", this_log), ("other", other_log)):
        ptx[tree] = {k: list(ptxas_summary(log, k)) for k in KERNELS}
        for k, entries in ptx[tree].items():
            for entry in entries:
                print(json.dumps({"ptxas": tree, "kernel": k, **entry}), flush=True)
    kernel_turns(lib_this, lib_other, ptx, args.rounds, args.variant)
    if args.steps:
        from clip_dplm_tpu_torch.experiments.gemm_ab import step_turns

        for _ in range(args.rounds):
            step_turns(other, args.steps.split(","))
    for model in filter(None, args.profile.split(",")):
        profile_tiny(other, model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
