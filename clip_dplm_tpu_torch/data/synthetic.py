"""Deterministic synthetic paired embeddings and the in-memory paired
dataset: `make_paired_embeddings` and `PairedEmbeddingDataset` of
`clip_dplm_tpu/data/synthetic.py`, which are numpy only and copied as they
are. Two views share a low-rank latent, so contrastive training has signal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


def make_paired_embeddings(
    n: int,
    dim_a: int,
    dim_b: int,
    latent_dim: int = 16,
    noise: float = 0.1,
    n_classes: Optional[int] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Paired vectors sharing a low-rank latent: a = z Wa + eps, b = z Wb + eps.

    Mirrors the structure of the reference's DiffMap<->marker pairs
    (run1/full.py:106-119: adata.obsm['X_diffmap'] vs marker vectors): two
    views of the same underlying cell state. `n_classes` adds cluster
    structure for confusion/collapse analyses.
    """
    rng = np.random.default_rng(seed)
    if n_classes:
        centers = rng.normal(size=(n_classes, latent_dim)).astype(np.float32)
        labels = rng.integers(0, n_classes, size=n)
        z = centers[labels] + 0.3 * rng.normal(size=(n, latent_dim)).astype(np.float32)
    else:
        labels = np.zeros(n, dtype=np.int64)
        z = rng.normal(size=(n, latent_dim)).astype(np.float32)
    wa = rng.normal(size=(latent_dim, dim_a)).astype(np.float32) / np.sqrt(latent_dim)
    wb = rng.normal(size=(latent_dim, dim_b)).astype(np.float32) / np.sqrt(latent_dim)
    a = z @ wa + noise * rng.normal(size=(n, dim_a)).astype(np.float32)
    b = z @ wb + noise * rng.normal(size=(n, dim_b)).astype(np.float32)
    return {"a": a.astype(np.float32), "b": b.astype(np.float32), "labels": labels}


@dataclasses.dataclass
class PairedEmbeddingDataset:
    """In-memory paired-embedding dataset with shuffled batch iteration.

    Capability match for ImmuneCellDataset + DataLoader (run1/full.py:106-119)
    with deterministic seeding; drops the ragged tail so every batch is
    static-shaped for XLA.
    """

    a: np.ndarray
    b: np.ndarray
    labels: Optional[np.ndarray] = None
    gaussian_noise: float = 0.0  # GaussianNoise transform (run1/full.py:114-119)

    def __len__(self) -> int:
        return self.a.shape[0]

    def batches(
        self, batch_size: int, seed: int = 0, shuffle: bool = True,
        train: bool = False,
    ) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self)
        rng = np.random.default_rng(seed)
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - batch_size + 1, batch_size):
            sel = idx[start : start + batch_size]
            a = self.a[sel]
            if train and self.gaussian_noise > 0:
                a = a + self.gaussian_noise * rng.normal(size=a.shape).astype(a.dtype)
            out = {"a": a, "b": self.b[sel]}
            if self.labels is not None:
                out["labels"] = self.labels[sel]
            yield out

    @classmethod
    def synthetic(cls, n: int, dim_a: int, dim_b: int, **kw) -> "PairedEmbeddingDataset":
        d = make_paired_embeddings(n, dim_a, dim_b, **kw)
        return cls(a=d["a"], b=d["b"], labels=d["labels"])

    def split(self, frac: float = 0.85, seed: int = 0):
        """85/15 split (run1/proposal.MD:3)."""
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self))
        cut = int(len(self) * frac)
        tr, va = idx[:cut], idx[cut:]
        mk = lambda s: PairedEmbeddingDataset(
            a=self.a[s], b=self.b[s],
            labels=None if self.labels is None else self.labels[s],
            gaussian_noise=self.gaussian_noise,
        )
        return mk(tr), mk(va)
