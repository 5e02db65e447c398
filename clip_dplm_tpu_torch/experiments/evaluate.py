"""Evaluation CLI: `python -m clip_dplm_tpu_torch.experiments.evaluate`.

Counterpart of `clip_dplm_tpu/experiments/evaluate.py` for the pair models
(two_tower, rna_rbp, esm_clip: a forward that returns emb_a and emb_b):
restore a checkpoint (train/checkpoint.py) into the model the config
builds, run the validation split through its deterministic forward, and
write the retrieval metrics of each batch as their mean and std over the
batches (`R@1_mean`, `R@1_std`, ...) and those of the whole split
(`full_R@1`, ...; train/metrics.py::BiologicalMetrics, computed on the
device) into a CSV of (metric, value) rows, `<logging.log_dir>/
eval_metrics.csv` unless `--output` names another. `--save-embeddings`
writes the split's emb_a and emb_b to an .npz. The config is the run's
`config.yaml` (`--config`; utils/pretrained.py::read_config) or the
default one, then the `-o` overrides. Runs on the card unless `--device
cpu` is given.

  python -m clip_dplm_tpu_torch.experiments.evaluate \\
      --config runs/config.yaml --checkpoint runs/ckpt --save-embeddings emb.npz
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="config.yaml of the run")
    p.add_argument("--override", "-o", action="append", default=[],
                   help="dotted config override, e.g. -o train.batch_size=64")
    p.add_argument("--checkpoint", required=True, help="checkpoint dir")
    p.add_argument("--output", default=None, help="metrics CSV path")
    p.add_argument("--save-embeddings", default=None, help=".npz path for the embeddings")
    p.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
    from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager
    from clip_dplm_tpu_torch.train.metrics import BiologicalMetrics, retrieval_metrics
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import to_device
    from clip_dplm_tpu_torch.utils.pretrained import read_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to evaluate on the CPU)")
    cfg = read_config(args.config) if args.config else Config()
    cfg = apply_overrides(cfg, args.override)
    model = build_model(cfg, device=device)
    _, val_batches = build_data(cfg)
    state = create_train_state(model, cfg, init=False)
    CheckpointManager(args.checkpoint).restore(state)

    model.eval()
    all_a, all_b, per_batch = [], [], []
    with torch.no_grad():
        for batch in val_batches():
            out = model(to_device(batch, device), deterministic=True)
            if "emb_a" not in out or "emb_b" not in out:
                raise ValueError(f"experiment {cfg.experiment!r} gives no emb_a / emb_b: the "
                                 "evaluate CLI takes pair models")
            a, b = out["emb_a"].float(), out["emb_b"].float()
            all_a.append(a)
            all_b.append(b)
            per_batch.append(retrieval_metrics(a, b))
    if not per_batch:
        raise ValueError("the validation split gave no batch (batch_size larger than it?)")
    emb_a, emb_b = torch.cat(all_a), torch.cat(all_b)
    # one host read of every batch's metrics
    keys = sorted(per_batch[0])
    table = torch.stack([torch.stack([m[k] for k in keys]) for m in per_batch]).cpu().numpy()
    summary = {}
    for j, k in enumerate(keys):
        vals = [float(v) for v in table[:, j]]
        summary[f"{k}_mean"] = float(np.mean(vals))
        summary[f"{k}_std"] = float(np.std(vals))
    full = BiologicalMetrics().compute_all_metrics(emb_a, emb_b)
    summary.update({f"full_{k}": v for k, v in full.items()})

    out_path = args.output or os.path.join(cfg.logging.log_dir, "eval_metrics.csv")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "value"])
        for k, v in sorted(summary.items()):
            w.writerow([k, v])
    if args.save_embeddings:
        np.savez(args.save_embeddings, emb_a=emb_a.cpu().numpy(), emb_b=emb_b.cpu().numpy())
    print(json.dumps({k: v for k, v in summary.items() if k.startswith("full_R@")}), flush=True)
    return summary


if __name__ == "__main__":
    main()
