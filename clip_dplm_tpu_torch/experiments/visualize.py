"""Visualization CLI: `python -m clip_dplm_tpu_torch.experiments.visualize`.

Counterpart of `clip_dplm_tpu/experiments/visualize.py` for the pair models:
restore a checkpoint into the model the config builds, and write, from
the first validation batch's deterministic forward, the t-SNE panels of
both towers (`embeddings.png`) and their cosine-similarity heatmap
(`similarity.png`), and the train/val curves of the run's `metrics.csv`
(`training.png`; utils/logging.py's MetricLogger writes it into
`logging.log_dir`) when there is one, into `--out-dir`
(`<logging.log_dir>/figures` by default). Prints the figures' paths, one
a line. Needs matplotlib and scikit-learn (utils/visualization.py); without
either it exits with a message naming the missing package. Runs on the
card unless `--device cpu` is given.

  python -m clip_dplm_tpu_torch.experiments.visualize \\
      --config runs/config.yaml --checkpoint runs/ckpt -o logging.log_dir=runs
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="config.yaml of the run")
    p.add_argument("--override", "-o", action="append", default=[],
                   help="dotted config override, e.g. -o train.batch_size=64")
    p.add_argument("--checkpoint", required=True, help="checkpoint dir")
    p.add_argument("--out-dir", default=None, help="figure directory")
    p.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    args = parse_args(argv)
    from clip_dplm_tpu_torch.experiments.analyze import restored_model
    from clip_dplm_tpu_torch.ops.infonce import l2_normalize
    from clip_dplm_tpu_torch.train.trainer import to_device
    from clip_dplm_tpu_torch.utils import visualization

    gone = visualization.missing("matplotlib", "sklearn")
    if gone:
        raise SystemExit(f"visualize needs {' and '.join(gone)}, which "
                         f"{'is' if len(gone) == 1 else 'are'} not installed")
    cfg, model, _, val_batches, device = restored_model(args)
    viz = visualization.Visualizer(args.out_dir or os.path.join(cfg.logging.log_dir, "figures"))
    example = next(iter(val_batches()))
    with torch.no_grad():
        out = model(to_device(example, device), deterministic=True)
    emb_a, emb_b = out["emb_a"].float(), out["emb_b"].float()
    figures = [
        viz.plot_embeddings({"tower_a": emb_a.cpu().numpy(), "tower_b": emb_b.cpu().numpy()}),
        viz.plot_similarity_matrix((l2_normalize(emb_a) @ l2_normalize(emb_b).t()).cpu().numpy()),
    ]
    metrics_csv = os.path.join(cfg.logging.log_dir, "metrics.csv")
    if os.path.exists(metrics_csv):
        with open(metrics_csv) as f:
            rows = list(csv.DictReader(f))
        if rows:
            history = {k: [float(r[k]) for r in rows if r.get(k)]
                       for k in rows[0] if k not in ("step", "time")}
            figures.append(viz.plot_training_progress(history))
    print("\n".join(figures), flush=True)
    return figures


if __name__ == "__main__":
    main()
