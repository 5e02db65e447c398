"""Protein generation CLI: `python -m clip_dplm_tpu_torch.experiments.generate`.

Counterpart of `clip_dplm_tpu/experiments/generate.py`: sample proteins from
a DPLM with the confidence-remasking sampler and write them as FASTA, on the
card unless `--device cpu` is given. The DPLM comes from a pretrained bundle
(`--dplm-bundle`, utils/pretrained.py, written by either package) or is
DPLM 640/12/10 with random weights drawn from a generator seeded by `--seed`,
its trunk optionally warm-started from an ESM-2 bundle (`--esm-init`,
models/dplm.py::init_dplm_from_esm). With `--condition` (an .npz holding
`embedding`) and `--scorer-bundle` (an esm_clip model, or an ESM-2 tower)
generation is CLIP-guided: best-of-`--candidates` reranking by the cosine
of the bundle's ESM-2 tower's mean-residue embedding with the condition
(models/guided_generation.py), as the JAX package's CLI scores: the
condition has the tower's width, not the projection's (the server's
`--scorer-bundle` scores in the projected space instead).

  python -m clip_dplm_tpu_torch.experiments.generate --output out.fasta \\
      --dplm-bundle runs/dplm --length 100 --num 4 --steps 100
  python -m clip_dplm_tpu_torch.experiments.generate --output guided.fasta \\
      --dplm-bundle runs/dplm --scorer-bundle runs/esm_clip \\
      --condition rbp.npz --candidates 8
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--output", required=True, help="FASTA output path")
    p.add_argument("--length", type=int, default=100)
    p.add_argument("--num", type=int, default=4, help="sequences to generate")
    p.add_argument("--steps", type=int, default=None, help="denoising steps")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--dplm-bundle", default=None, help="pretrained DPLM bundle")
    p.add_argument("--esm-init", default=None,
                   help="warm-start the random trunk from an ESM-2 bundle")
    p.add_argument("--condition", default=None,
                   help=".npz with `embedding` to CLIP-guide toward (with --scorer-bundle; "
                        "the width of its ESM-2 tower)")
    p.add_argument("--scorer-bundle", default=None,
                   help="pretrained bundle providing the protein scorer")
    p.add_argument("--candidates", type=int, default=8,
                   help="best-of-K candidates a row for guided generation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    from clip_dplm_tpu_torch.config import DPLMConfig
    from clip_dplm_tpu_torch.data.protein import ESM_VOCAB
    from clip_dplm_tpu_torch.models.dplm import DPLM, init_dplm_from_esm, sample
    from clip_dplm_tpu_torch.models.guided_generation import generate_proteins_for_condition
    from clip_dplm_tpu_torch.models.layers import init_params
    from clip_dplm_tpu_torch.utils.pretrained import (
        dplm_of,
        esm_tower_of,
        load_pretrained,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to sample on the CPU)")
    if args.dplm_bundle:
        model = dplm_of(load_pretrained(args.dplm_bundle, device=device)[1])
    else:
        model = DPLM(DPLMConfig(), device=device)
        init_params(model, torch.Generator(device=device).manual_seed(args.seed))
        print("WARNING: no --dplm-bundle; sampling from RANDOM weights")
        if args.esm_init:
            init_dplm_from_esm(esm_tower_of(load_pretrained(args.esm_init, device=device)[1]),
                               model)
            print(f"warm-started trunk from {args.esm_init}")
    model.eval()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if bool(args.condition) != bool(args.scorer_bundle):
        warnings.warn("--condition and --scorer-bundle must be given together; "
                      "falling back to UNGUIDED sampling", stacklevel=1)
    if args.condition and args.scorer_bundle:
        tower = esm_tower_of(load_pretrained(args.scorer_bundle, device=device)[1]).eval()
        scorer = lambda toks, mask: tower(toks, mask, pooling="mean_residues")  # noqa: E731
        condition = np.load(args.condition)["embedding"]
        tokens, scores = generate_proteins_for_condition(
            model, scorer, condition, generator, length=args.length, batch_size=args.num,
            num_candidates=args.candidates, num_steps=args.steps,
            temperature=args.temperature)
    else:
        tokens, conf = sample(model, generator, args.num, args.length,
                              num_steps=args.steps, temperature=args.temperature)
        scores = torch.where(torch.isfinite(conf), conf, 0.0).sum(dim=-1)
    scores = scores.float().cpu().numpy()
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        for i, row in enumerate(np.asarray(tokens.cpu())):
            seq = "".join(ESM_VOCAB[t] for t in row[1:-1])
            f.write(f">generated_{i} score={scores[i]:.4f}\n{seq}\n")
    print(f"wrote {args.num} sequences of length {args.length} -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
