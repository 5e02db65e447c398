"""How `chip_smoke.py` 9(b), the tf_clip step card vs CPU, responds to the
last bits of the cell tower's attention:

    python -m clip_dplm_tpu_torch.experiments.tf_clip_leaf_probe [--other DIR]
        [--cases asis,flip8,flip64,plain] [--bf16-reduction as-is|off|both]

Run from the root of a checkout (it imports that checkout's `chip_smoke.py`).
Each case runs 9(b) on its own inputs (B=256, full widths, the same seed)
in a process of its own, with the smoke's checks recorded instead of raised,
and prints the worst leaf's error over its noise bound as the smoke's check
computes it (it fails above 3), the same for the step's own draw alone where
the smoke prints that beside it, and the checks that would have failed:
- `asis`: the tree as it is;
- `flipN`: N outputs of every flash-attention forward, drawn from a fixed
  seed, raised by about one bf16 step (x (1 + 2^-7)), the lse untouched;
- `plain`: the flash forward replaced by its plain version on the card
  (`attention_reference` and `flash_lse_reference`).
With `--other DIR`, `asis` and `flip8` also run in that checkout (for
example a parent commit unpacked with `git archive`). `--cases` picks the
cases (all four by default). `--bf16-reduction off` sets
`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction` to False
in each case's process before the step (cuBLAS then reduces bf16 products in
f32, as JAX does); `as-is` leaves the setting as the package has it; `both`
runs every case with each, off first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

CASE = r'''
import sys, torch, chip_smoke
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import flash_attention as fa
from clip_dplm_tpu_torch.ops.attention import attention_reference

_build.LIBRARY.get()
if sys.argv[2] == "off":
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
print("allow_bf16_reduced_precision_reduction:",
      torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
failed = []
chip_smoke.check = lambda ok, what: None if ok else failed.append(what)
mode = sys.argv[1]
if mode == "plain":
    def forward(q, k, v, mask, scale):
        _build.LAUNCHES.add("flash_attention")
        return (attention_reference(q, k, v, mask=mask, scale=scale),
                fa.flash_lse_reference(q, k, mask, scale).float())
    fa._flash_forward = forward
elif mode.startswith("flip"):
    kernel, n = fa._flash_forward, int(mode[4:])
    def forward(q, k, v, mask, scale):
        out, lse = kernel(q, k, v, mask, scale)
        g = torch.Generator(device=out.device).manual_seed(123)
        idx = torch.randint(0, out.numel(), (n,), generator=g, device=out.device)
        flat = out.reshape(-1).clone()
        flat[idx] = (flat[idx].float() * (1 + 2.0 ** -7)).to(out.dtype)
        return flat.view_as(out), lse
    fa._flash_forward = forward
chip_smoke.phase_tf_clip_step(torch)
for what in failed:
    print("would fail:", what)
'''


def run_case(tree: Path, mode: str, reduction: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CASE, mode, reduction], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} {mode}:\n{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    worst = re.search(r"worst leaf ([0-9.]+) x its noise \(([^)]*)\)", proc.stdout)
    one = re.search(r"draw 0 alone: ([0-9.]+)x \(([^)]*)\)", proc.stdout)
    flag = re.search(r"allow_bf16_reduced_precision_reduction: (\w+)", proc.stdout).group(1)
    fails = [line for line in proc.stdout.splitlines() if line.startswith("would fail:")]
    print(f"{tree.name or tree} {mode} (bf16 reduced-precision reduction {flag}): "
          f"worst leaf {worst.group(1)}x ({worst.group(2)})"
          + ("" if one is None else f"; draw 0 alone {one.group(1)}x ({one.group(2)})"))
    for line in fails:
        print("  ", line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout of the repo")
    ap.add_argument("--cases", default="asis,flip8,flip64,plain",
                    help="comma-separated cases of this checkout")
    ap.add_argument("--bf16-reduction", choices=("as-is", "off", "both"), default="as-is")
    args = ap.parse_args(argv)
    here = Path.cwd().resolve()
    cases = [(here, m) for m in args.cases.split(",")]
    if args.other is not None:
        cases += [(args.other.resolve(), m) for m in ("asis", "flip8")]
    settings = ("off", "as-is") if args.bf16_reduction == "both" else (args.bf16_reduction,)
    for reduction in settings:
        for tree, mode in cases:
            run_case(tree, mode, reduction)
    return 0


if __name__ == "__main__":
    sys.exit(main())
