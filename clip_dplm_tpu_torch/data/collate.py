"""Host-side collation of variable-length token sequences: static-shaped
padded batches with explicit boolean masks (True = real token).

`pad_token_batch`, `nan_padded_to_masked`, `_pad_seq_dim` and
`TokenPairDataset` (its `batches` and `synthetic`) of
`clip_dplm_tpu/data/collate.py`, which are numpy only and copied as they are,
so one seed gives the same batches in both packages. `cluster_split` runs its
k-means on `train/analysis.py::kmeans`, which gives scikit-learn 1.9.0's
`KMeans(n_init=4, random_state=seed)` labels without scikit-learn (the
card's machine has none).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def pad_token_batch(
    seqs: Sequence[np.ndarray], max_len: Optional[int] = None,
    pad_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack (L_i, D) arrays into ((B, S, D), (B, S) bool mask), padding to a
    multiple of `pad_multiple` for stable XLA shapes."""
    B = len(seqs)
    D = seqs[0].shape[1]
    L = max(s.shape[0] for s in seqs)
    if max_len is not None:
        L = min(L, max_len)
    S = ((L + pad_multiple - 1) // pad_multiple) * pad_multiple
    out = np.zeros((B, S, D), dtype=np.float32)
    mask = np.zeros((B, S), dtype=bool)
    for i, s in enumerate(seqs):
        n = min(s.shape[0], S)
        out[i, :n] = s[:n]
        mask[i, :n] = True
    return out, mask


def nan_padded_to_masked(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Convert a NaN-padded batch (the reference's device-side convention,
    rna nb cell 24) into (zero-filled batch, bool mask) at the host boundary."""
    mask = ~np.isnan(x).any(axis=-1)
    return np.nan_to_num(x, nan=0.0), mask


@dataclasses.dataclass
class TokenPairDataset:
    """Paired variable-length token sequences (RNA motif embeddings 120-d vs
    RBP residue embeddings 1280-d — rna nb cells 24-29 data model)."""

    seqs_a: List[np.ndarray]
    seqs_b: List[np.ndarray]
    max_len_a: Optional[int] = None
    max_len_b: Optional[int] = None

    def __len__(self) -> int:
        return len(self.seqs_a)

    def batches(
        self, batch_size: int, seed: int = 0, shuffle: bool = True,
        pad_to_a: Optional[int] = None, pad_to_b: Optional[int] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self)
        rng = np.random.default_rng(seed)
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - batch_size + 1, batch_size):
            sel = idx[start : start + batch_size]
            a, am = pad_token_batch([self.seqs_a[i] for i in sel], self.max_len_a)
            b, bm = pad_token_batch([self.seqs_b[i] for i in sel], self.max_len_b)
            if pad_to_a is not None:
                a, am = _pad_seq_dim(a, am, pad_to_a)
            if pad_to_b is not None:
                b, bm = _pad_seq_dim(b, bm, pad_to_b)
            yield {
                "rna_tokens": a, "rna_mask": am,
                "rbp_tokens": b, "rbp_mask": bm,
            }

    @classmethod
    def synthetic(
        cls, n: int, dim_a: int = 120, dim_b: int = 1280,
        len_range_a: Tuple[int, int] = (8, 64),
        len_range_b: Tuple[int, int] = (16, 128),
        latent_dim: int = 16, noise: float = 0.1, seed: int = 0,
    ) -> "TokenPairDataset":
        """Paired sequences whose mean-pooled content shares a latent — so
        contrastive training on synthetic data has learnable signal."""
        rng = np.random.default_rng(seed)
        wa = rng.normal(size=(latent_dim, dim_a)).astype(np.float32)
        wb = rng.normal(size=(latent_dim, dim_b)).astype(np.float32)
        seqs_a, seqs_b = [], []
        for _ in range(n):
            z = rng.normal(size=(latent_dim,)).astype(np.float32)
            la = int(rng.integers(*len_range_a))
            lb = int(rng.integers(*len_range_b))
            base_a = (z @ wa) / np.sqrt(latent_dim)
            base_b = (z @ wb) / np.sqrt(latent_dim)
            seqs_a.append(
                base_a[None, :]
                + noise * rng.normal(size=(la, dim_a)).astype(np.float32)
            )
            seqs_b.append(
                base_b[None, :]
                + noise * rng.normal(size=(lb, dim_b)).astype(np.float32)
            )
        return cls(seqs_a=seqs_a, seqs_b=seqs_b)


def _pad_seq_dim(x: np.ndarray, mask: np.ndarray, S: int):
    if x.shape[1] >= S:
        return x[:, :S], mask[:, :S]
    pad = S - x.shape[1]
    return (
        np.pad(x, ((0, 0), (0, pad), (0, 0))),
        np.pad(mask, ((0, 0), (0, pad))),
    )


def cluster_split(
    seqs_a: Sequence[np.ndarray],
    seqs_b: Sequence[np.ndarray],
    val_fraction: float = 0.15,
    n_clusters: int = 20,
    seed: int = 0,
) -> Tuple["TokenPairDataset", "TokenPairDataset"]:
    """Cluster-based train/val split (rna nb cell 29 semantics: whole motif
    clusters go to one side, so near-duplicate sequences never straddle the
    split). Clusters are k-means over the mean-pooled token embeddings of
    side a; clusters join the validation side in a seeded random order until
    it holds `val_fraction` of the rows."""
    from clip_dplm_tpu_torch.train.analysis import kmeans

    pooled = np.stack([s.mean(axis=0) for s in seqs_a])
    k = min(n_clusters, len(seqs_a))
    labels = kmeans(pooled, n_clusters=k, n_init=4, random_state=seed)[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(k)
    target_val = int(len(seqs_a) * val_fraction)
    val_clusters = set()
    count = 0
    for c in order:
        if count >= target_val:
            break
        val_clusters.add(int(c))
        count += int((labels == c).sum())
    val_idx = [i for i, l in enumerate(labels) if l in val_clusters]
    train_idx = [i for i, l in enumerate(labels) if l not in val_clusters]
    mk = lambda idx: TokenPairDataset(  # noqa: E731
        [seqs_a[i] for i in idx], [seqs_b[i] for i in idx])
    return mk(train_idx), mk(val_idx)
