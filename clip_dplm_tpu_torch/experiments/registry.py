"""Experiment registry: config.experiment -> (model, data source).

Counterpart of `clip_dplm_tpu/experiments/registry.py` for
`experiment="two_tower"`, the only experiment the port has so far; every
other name raises.
"""

from __future__ import annotations

import numpy as np
import torch

from clip_dplm_tpu_torch.config import Config
from clip_dplm_tpu_torch.data.synthetic import PairedEmbeddingDataset


def _require_two_tower(cfg: Config) -> None:
    if cfg.experiment != "two_tower":
        raise ValueError(f"experiment {cfg.experiment!r} is not ported; the port has "
                         "two_tower only")


def build_model(cfg: Config, device=None, dtype: torch.dtype = torch.bfloat16):
    _require_two_tower(cfg)
    from clip_dplm_tpu_torch.models.clip import TwoTowerCLIP

    return TwoTowerCLIP(cfg, dtype=dtype, device=device)


def build_data(cfg: Config, split_seed: int = 0):
    """(train_batches_fn, val_batches_fn): callables yielding fresh iterators
    of numpy batches {"a", "b"}. `dataset=synthetic` is the 2048-pair
    fixture of the reference; `dataset=embeddings` loads an .npz with `a`
    and `b` from data.path. 85/15 split, ragged tail dropped."""
    _require_two_tower(cfg)
    d = cfg.data
    if d.dataset == "embeddings":
        if not d.path:
            raise ValueError("dataset=embeddings needs data.path")
        z = np.load(d.path)
        ds = PairedEmbeddingDataset(a=z["a"].astype(np.float32), b=z["b"].astype(np.float32),
                                    labels=z["labels"] if "labels" in z else None)
    elif d.dataset == "synthetic":
        ds = PairedEmbeddingDataset.synthetic(
            2048, cfg.tower_a.input_dim, cfg.tower_b.input_dim, n_classes=8, seed=split_seed)
    else:
        raise ValueError(f"unknown dataset {d.dataset!r}")
    train, val = ds.split(0.85, seed=split_seed)
    B = cfg.train.batch_size

    def strip(b):
        return {k: v for k, v in b.items() if k != "labels"}

    return (lambda seed=0: (strip(b) for b in train.batches(B, seed=seed)),
            lambda: (strip(b) for b in val.batches(B, shuffle=False)))
