"""Experiment registry: config.experiment -> (model, data source).

Counterpart of `clip_dplm_tpu/experiments/registry.py` for the experiments
the port has: `two_tower` and `rna_rbp`; every other name raises.
"""

from __future__ import annotations

import numpy as np
import torch

from clip_dplm_tpu_torch.config import Config
from clip_dplm_tpu_torch.data.collate import TokenPairDataset
from clip_dplm_tpu_torch.data.synthetic import PairedEmbeddingDataset

EXPERIMENTS = ("two_tower", "rna_rbp")


def _require_ported(cfg: Config) -> None:
    if cfg.experiment not in EXPERIMENTS:
        raise ValueError(f"experiment {cfg.experiment!r} is not ported; the port has "
                         f"{', '.join(EXPERIMENTS)}")


def build_model(cfg: Config, device=None, dtype: torch.dtype = torch.bfloat16):
    """The experiment's model on `device` (the caller's choice)."""
    _require_ported(cfg)
    if cfg.experiment == "rna_rbp":
        from clip_dplm_tpu_torch.models.token_towers import RNARBPCLIP

        return RNARBPCLIP(cfg, dtype=dtype, device=device)
    from clip_dplm_tpu_torch.models.clip import TwoTowerCLIP

    return TwoTowerCLIP(cfg, dtype=dtype, device=device)


def build_data(cfg: Config, split_seed: int = 0):
    """(train_batches_fn, val_batches_fn): callables yielding fresh iterators
    of numpy batches. two_tower: {"a", "b"}; `dataset=synthetic` is the
    2048-pair fixture of the reference, `dataset=embeddings` loads an .npz
    with `a` and `b` from data.path; 85/15 split. rna_rbp: {"rna_tokens",
    "rna_mask", "rbp_tokens", "rbp_mask"} from 1024 synthetic token-sequence
    pairs, the first 85 % for training, padded to 64 / 128 tokens. The
    ragged tail is dropped."""
    _require_ported(cfg)
    B = cfg.train.batch_size
    if cfg.experiment == "rna_rbp":
        ds = TokenPairDataset.synthetic(1024, dim_a=cfg.rna_tower.input_dim,
                                        dim_b=cfg.rbp_tower.input_dim, seed=split_seed)
        cut = int(len(ds) * 0.85)
        train = TokenPairDataset(ds.seqs_a[:cut], ds.seqs_b[:cut])
        val = TokenPairDataset(ds.seqs_a[cut:], ds.seqs_b[cut:])
        pa, pb = 64, 128
        return (lambda seed=0: train.batches(B, seed=seed, pad_to_a=pa, pad_to_b=pb),
                lambda: val.batches(B, shuffle=False, pad_to_a=pa, pad_to_b=pb))
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

    def strip(b):
        return {k: v for k, v in b.items() if k != "labels"}

    return (lambda seed=0: (strip(b) for b in train.batches(B, seed=seed)),
            lambda: (strip(b) for b in val.batches(B, shuffle=False)))
