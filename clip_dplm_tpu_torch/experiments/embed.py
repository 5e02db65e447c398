"""Batch embedding CLI: `python -m clip_dplm_tpu_torch.experiments.embed`.

Counterpart of `clip_dplm_tpu/experiments/embed.py`: protein sequences in
(FASTA, or one sequence a line) -> pooled ESM-2 embeddings out (.npz with
`names` and `embeddings`, f32), on the card unless `--device cpu` is given.
Every batch is padded to `--batch-size` rows and `--max-len` tokens (one
shape for the whole stream), so a length of 256 or more runs the flash
kernel and 64 to 255 the packed short-S kernel. The tower comes from a
pretrained bundle (`--bundle`: an ESM-2 tower, or an esm_clip model's) or,
without one, from random weights of the `--esm` family:

  python -m clip_dplm_tpu_torch.experiments.embed --input seqs.fasta \\
      --output emb.npz --bundle runs/esm2_650m --max-len 1024

Tokenization is the host C++ tokenizer (`native/bindings.py::
tokenize_batch_native`, built with g++ on first use; the same ids and masks
as `data/protein.py::tokenize_batch`), as the JAX package's CLI tokenizes;
`--pipeline-stages` > 1 (the trunk pipelined over several devices) is queue 1
item 13 and raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def read_sequences(path: str) -> Tuple[List[str], List[str]]:
    """FASTA or plain one-sequence-per-line. Returns (names, sequences)."""
    names, seqs = [], []
    with open(path) as f:
        current_name, current = None, []
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if current_name is not None:
                    names.append(current_name)
                    seqs.append("".join(current))
                current_name, current = line[1:].split()[0], []
            elif current_name is not None:
                current.append(line)
            else:  # plain text mode
                names.append(f"seq{len(names)}")
                seqs.append(line)
        if current_name is not None:
            names.append(current_name)
            seqs.append("".join(current))
    return names, seqs


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="FASTA or text file")
    p.add_argument("--output", required=True, help=".npz output")
    p.add_argument("--bundle", default=None,
                   help="pretrained bundle dir (utils/pretrained.py); default: a random "
                        "ESM-2 tower of --esm")
    p.add_argument("--esm", default="esm2_t6_8M", help="ESM-2 family when no bundle is given")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--pooling", default="mean_residues", choices=["mean_residues", "cls"])
    p.add_argument("--pipeline-stages", type=int, default=0,
                   help="pipeline the trunk over this many devices (not ported: > 1 raises)")
    p.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    args = parse_args(argv)
    from clip_dplm_tpu_torch.data.protein import PAD_IDX
    from clip_dplm_tpu_torch.native import tokenize_batch_native
    from clip_dplm_tpu_torch.models.esm import ESMTower, esm_config_from_name
    from clip_dplm_tpu_torch.models.layers import init_params
    from clip_dplm_tpu_torch.utils.pretrained import esm_tower_of, load_pretrained

    if args.pipeline_stages > 1:
        raise SystemExit("--pipeline-stages: the pipelined trunk is not ported "
                         "(ROADMAP queue 1 item 13)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to embed on the CPU)")
    names, seqs = read_sequences(args.input)
    if not seqs:
        raise SystemExit(f"no sequences found in {args.input}")
    if args.bundle:
        tower = esm_tower_of(load_pretrained(args.bundle, device=device)[1])
    else:
        tower = ESMTower(esm_config_from_name(args.esm, max_len=args.max_len), device=device)
        init_params(tower, torch.Generator(device=device).manual_seed(0))
        print("WARNING: no --bundle given; embedding with RANDOM weights "
              "(convert a checkpoint with models.esm.convert_esm_torch_params)")
    tower.eval()

    S, B = args.max_len, args.batch_size
    chunks = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for start in range(0, len(seqs), B):
            chunk = seqs[start:start + B]
            toks, mask = tokenize_batch_native(chunk + ["L"] * (B - len(chunk)), max_len=S)
            if toks.shape[1] < S:  # one padded length for the whole stream
                toks = np.pad(toks, ((0, 0), (0, S - toks.shape[1])), constant_values=PAD_IDX)
                mask = np.pad(mask, ((0, 0), (0, S - mask.shape[1])))
            emb = tower(torch.from_numpy(toks).to(device), torch.from_numpy(mask).to(device),
                        pooling=args.pooling)
            chunks.append(emb[:len(chunk)].float().cpu().numpy())
    embeddings = np.concatenate(chunks)
    elapsed = time.perf_counter() - t0

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    np.savez_compressed(args.output, names=np.asarray(names), embeddings=embeddings)
    print(f"embedded {len(seqs)} sequences -> {args.output} ({embeddings.shape[1]}-d, "
          f"{len(seqs) / max(elapsed, 1e-9):.1f} seq/s)")
    return {"names": np.asarray(names), "embeddings": embeddings,
            "seqs_per_s": len(seqs) / max(elapsed, 1e-9)}


if __name__ == "__main__":
    main()
