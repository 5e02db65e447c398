"""Analysis CLI: `python -m clip_dplm_tpu_torch.experiments.analyze`.

Counterpart of `clip_dplm_tpu/experiments/analyze.py` for the pair models:
restore a checkpoint (train/checkpoint.py) into the model the config
builds, run the validation split through its deterministic forward, and
write the analysis report (train/analysis.py) as JSON, `<logging.log_dir>/
analysis.json` unless `--out` names another: `retrieval`; `cache_stats`
when the checkpoint carries a filled hard-negative cache; `distributions`
(the PCA spectrum of each tower); `failure_cases`; and, where the batches
carry raw `a` features, `marker_space`, `class_confusion` and
`embedding_collapse` over k-means pseudo-labels of the raw features
(`train/analysis.py::kmeans`, scikit-learn's KMeans(n_clusters=k, n_init=4,
random_state=0) written in numpy, k = min(8, max(2, n // 32))). Prints a
one-line JSON summary. Then draws the t-SNE figure of both towers into
`<logging.log_dir>/figures/analysis_embeddings.png` where matplotlib and
scikit-learn import; elsewhere it warns once, naming what is missing, and
ends with the report written. The config is the run's `config.yaml`
(`--config`) or the default one, then the `-o` overrides. Runs on the card
unless `--device cpu` is given.

  python -m clip_dplm_tpu_torch.experiments.analyze \\
      --config runs/config.yaml --checkpoint runs/ckpt [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="config.yaml of the run")
    p.add_argument("--override", "-o", action="append", default=[],
                   help="dotted config override, e.g. -o train.batch_size=64")
    p.add_argument("--checkpoint", required=True, help="checkpoint dir")
    p.add_argument("--out", default=None, help="JSON report path")
    p.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    return p.parse_args(argv)


def restored_model(args: argparse.Namespace):
    """(cfg, model, state, val_batches, device) of a CLI's flags: the config,
    the model on the device with the checkpoint's state restored, the
    validation split."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
    from clip_dplm_tpu_torch.train.checkpoint import CheckpointManager
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.utils.pretrained import read_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    cfg = read_config(args.config) if args.config else Config()
    cfg = apply_overrides(cfg, args.override)
    model = build_model(cfg, device=device)
    _, val_batches = build_data(cfg)
    state = create_train_state(model, cfg, init=False)
    CheckpointManager(args.checkpoint).restore(state)
    model.eval()
    return cfg, model, state, val_batches, device


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    from clip_dplm_tpu_torch.train.analysis import (
        analyze_cell_type_confusion,
        analyze_embedding_collapse,
        analyze_embedding_distributions,
        analyze_failure_cases,
        compute_confusion_matrix,
        hard_negative_cache_stats,
        kmeans,
        marker_space_analysis,
    )
    from clip_dplm_tpu_torch.train.metrics import retrieval_metrics
    from clip_dplm_tpu_torch.train.trainer import to_device
    from clip_dplm_tpu_torch.utils import visualization

    cfg, model, state, val_batches, device = restored_model(args)
    all_a, all_b, all_raw_a = [], [], []
    with torch.no_grad():
        for batch in val_batches():
            out = model(to_device(batch, device), deterministic=True)
            all_a.append(out["emb_a"].float())
            all_b.append(out["emb_b"].float())
            if "a" in batch:
                all_raw_a.append(np.asarray(batch["a"], np.float32))
    if not all_a:
        raise ValueError("the validation split gave no batch (batch_size larger than it?)")
    ta, tb = torch.cat(all_a), torch.cat(all_b)
    emb_a, emb_b = ta.cpu().numpy(), tb.cpu().numpy()

    report: dict = {"retrieval": {k: float(v) for k, v in retrieval_metrics(ta, tb).items()}}
    cache_len = 0 if state.cache_len is None else int(state.cache_len)
    if cfg.contrastive.use_cache and cache_len > 0:
        report["cache_stats"] = hard_negative_cache_stats(
            emb_a, emb_b, state.cache.float().cpu().numpy(), cache_len)
    report |= {
        "distributions": analyze_embedding_distributions({"tower_a": emb_a, "tower_b": emb_b}),
        "failure_cases": analyze_failure_cases(emb_a, emb_b, top_k=10),
    }
    if all_raw_a:
        raw_a = np.concatenate(all_raw_a)
        report["marker_space"] = marker_space_analysis(raw_a, emb_a)
        # pseudo-labels from marker-space clustering for confusion/collapse
        k = min(8, max(2, raw_a.shape[0] // 32))
        labels = kmeans(raw_a, k, n_init=4, random_state=0)[0]
        cm = compute_confusion_matrix(emb_a, emb_b, labels, k)
        report["class_confusion"] = {"matrix": cm.tolist(),
                                     "worst_pairs": analyze_cell_type_confusion(cm)[:10]}
        report["embedding_collapse"] = analyze_embedding_collapse(
            {"tower_a": emb_a, "tower_b": emb_b}, labels)

    out_path = args.out or os.path.join(cfg.logging.log_dir, "analysis.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, default=float)

    gone = visualization.missing("matplotlib", "sklearn")
    if gone:
        warnings.warn(f"analyze: no t-SNE figure: {' and '.join(gone)} not installed "
                      "(the report is written)", stacklevel=2)
    else:
        viz = visualization.Visualizer(os.path.join(cfg.logging.log_dir, "figures"))
        viz.plot_embeddings({"tower_a": emb_a, "tower_b": emb_b}, name="analysis_embeddings")

    print(json.dumps({
        "R@1": report["retrieval"]["R@1"],
        "effective_rank_a": report["distributions"]["tower_a"]["effective_rank"],
        "n_failure_cases": len(report["failure_cases"]),
        "report": out_path,
    }), flush=True)
    return report


if __name__ == "__main__":
    main()
