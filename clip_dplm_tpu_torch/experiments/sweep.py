"""Sweep CLI: `python -m clip_dplm_tpu_torch.experiments.sweep`.

Counterpart of `clip_dplm_tpu/experiments/sweep.py`: run the named sweep
grid (embedding_sweep / architecture_search / training_sweep /
temperature_sweep; config.py::create_experiment_configs), one short
training per variant through the registry and the Trainer, and write the
grid of best validation loss and final train loss to
`<logging.log_dir>/sweep_<name>.csv`. Runs on the card unless `--device
cpu` is given.

`--parallel` spreads the variants over the host's cards: variant i trains
on card i mod `torch.cuda.device_count()`, one thread a card. With
one card (or on the CPU) the variants run one after another, as the JAX
package runs them on one device. Runs over several cards are still to be
tested (ROADMAP.md, queue 1 item 13).

  python -m clip_dplm_tpu_torch.experiments.sweep --sweep temperature_sweep --epochs 3
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
from typing import Dict, Optional, Sequence

import torch


def _train_variant(name, cfg, epochs, device):
    """Train one sweep variant on `device`; (name, summary row)."""
    from clip_dplm_tpu_torch.experiments.registry import build_data, build_model
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import Trainer

    device = torch.device(device)
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        model = build_model(cfg, device=device)
        train_batches, val_batches = build_data(cfg)
        state = create_train_state(model, cfg)
        history = Trainer(cfg, state).train(lambda: train_batches(seed=0), val_batches,
                                            num_epochs=epochs)
    best_val = min(history["val_loss"]) if history["val_loss"] else float("nan")
    row = {"best_val_loss": best_val, "final_train_loss": history["train_loss"][-1]}
    print(f"{name}: best_val_loss={best_val:.4f}", flush=True)
    return name, row


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="config.yaml of a run")
    p.add_argument("--override", "-o", action="append", default=[],
                   help="dotted config override, e.g. -o train.batch_size=64")
    p.add_argument("--sweep", required=True,
                   choices=["embedding_sweep", "architecture_search", "training_sweep",
                            "temperature_sweep"])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--parallel", action="store_true",
                   help="train one variant per local card concurrently")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    args = parse_args(argv)
    from clip_dplm_tpu_torch.config import Config, apply_overrides, create_experiment_configs
    from clip_dplm_tpu_torch.utils.pretrained import read_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    base = read_config(args.config) if args.config else Config()
    base = apply_overrides(base, args.override)
    variants = create_experiment_configs(base, args.sweep)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    results = {}
    if args.parallel and cards > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=cards) as pool:
            futures = [pool.submit(_train_variant, name, cfg, args.epochs, f"cuda:{i % cards}")
                       for i, (name, cfg) in enumerate(variants)]
            for fut in futures:
                name, row = fut.result()
                results[name] = row
    else:
        for name, cfg in variants:
            name, row = _train_variant(name, cfg, args.epochs, device)
            results[name] = row

    out_path = os.path.join(base.logging.log_dir, f"sweep_{args.sweep}.csv")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["variant", "best_val_loss", "final_train_loss"])
        for name, r in results.items():
            w.writerow([name, r["best_val_loss"], r["final_train_loss"]])
    return results


if __name__ == "__main__":
    main()
