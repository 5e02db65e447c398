"""Protein generation CLI: `python -m clip_dplm_tpu_torch.experiments.generate`.

Counterpart of `clip_dplm_tpu/experiments/generate.py`: sample proteins from
a DPLM with the confidence-remasking sampler and write them as FASTA, on the
card unless `--device cpu` is given. Weights are random (DPLM 640/12/10 by
default), drawn from a generator seeded by `--seed` on the device; loading
a pretrained DPLM (`--dplm-bundle`), warm-starting from ESM-2 (`--esm-init`)
and CLIP guidance from a scorer bundle (`--condition` with
`--scorer-bundle`) wait for the utils/pretrained.py converters and raise.

  python -m clip_dplm_tpu_torch.experiments.generate --output out.fasta \\
      --length 100 --num 4 --steps 100
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

_CONVERTERS = "the pretrained-bundle converters (utils/pretrained.py, ROADMAP queue 1 item 10)"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--output", required=True, help="FASTA output path")
    p.add_argument("--length", type=int, default=100)
    p.add_argument("--num", type=int, default=4, help="sequences to generate")
    p.add_argument("--steps", type=int, default=None, help="denoising steps")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--dplm-bundle", default=None,
                   help="pretrained DPLM bundle (not ported yet: giving one raises)")
    p.add_argument("--esm-init", default=None,
                   help="warm-start the trunk from an ESM bundle (not ported yet)")
    p.add_argument("--condition", default=None,
                   help=".npz with `embedding` to CLIP-guide toward (with --scorer-bundle)")
    p.add_argument("--scorer-bundle", default=None,
                   help="pretrained bundle with the protein scorer (not ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    from clip_dplm_tpu_torch.config import DPLMConfig
    from clip_dplm_tpu_torch.data.protein import ESM_VOCAB
    from clip_dplm_tpu_torch.models.dplm import DPLM, sample
    from clip_dplm_tpu_torch.models.layers import init_params

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to sample on the CPU)")
    for flag, value in (("--dplm-bundle", args.dplm_bundle), ("--esm-init", args.esm_init)):
        if value:
            raise SystemExit(f"{flag}: loading pretrained weights waits for {_CONVERTERS}")
    if bool(args.condition) != bool(args.scorer_bundle):
        warnings.warn("--condition and --scorer-bundle must be given together; "
                      "falling back to UNGUIDED sampling", stacklevel=1)
    if args.condition and args.scorer_bundle:
        raise SystemExit(f"--scorer-bundle: CLIP-guided generation from a pretrained scorer "
                         f"waits for {_CONVERTERS}")
    model = DPLM(DPLMConfig(), device=device)
    init_params(model, torch.Generator(device=device).manual_seed(args.seed))
    print("WARNING: no --dplm-bundle; sampling from RANDOM weights")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    tokens, conf = sample(model.eval(), generator, args.num, args.length,
                          num_steps=args.steps, temperature=args.temperature)
    scores = torch.where(torch.isfinite(conf), conf, 0.0).sum(dim=-1).cpu().numpy()
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        for i, row in enumerate(np.asarray(tokens.cpu())):
            seq = "".join(ESM_VOCAB[t] for t in row[1:-1])
            f.write(f">generated_{i} score={scores[i]:.4f}\n{seq}\n")
    print(f"wrote {args.num} sequences of length {args.length} -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
