"""Multi-modal dataset and graph-aware batching for TripleFlowModel.

A copy of `clip_dplm_tpu/data/multimodal.py` (numpy on the host, on the
port's `AugmentConfig` and data/cells.py):
- `MemoryQueue`: the FIFO ring buffer of contrastive negatives (host side);
- `DataAugmentation`: gene dropout, edge dropout and perturbation-value
  noise from its own numpy generator;
- `TripleFlowDataset`: cells (trajectory info computed once), the top-DEG
  perturbation (indices, values, the pooled ESM of the genes) and the
  protein embedding; `batch(ids)` is the induced subgraph of the kNN graph,
  its edges padded to 16 a node with a mask;
- `MultiModalBatch`: the collator merging graphs with edge offsets and
  per-node graph ids;
- `get_dataloader`: batches of a dataset, augmented when asked.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from clip_dplm_tpu_torch.config import AugmentConfig
from clip_dplm_tpu_torch.data.cells import CellData, compute_trajectory_info, top_degs


class MemoryQueue:
    """FIFO ring buffer (size x dim) with wraparound enqueue."""

    def __init__(self, size: int, dim: int):
        self.queue = np.zeros((size, dim), np.float32)
        self.ptr = 0
        self.filled = 0
        self.size = size

    def enqueue_dequeue(self, batch: np.ndarray) -> None:
        b = batch.shape[0]
        if b >= self.size:
            self.queue[:] = batch[-self.size:]
            self.ptr, self.filled = 0, self.size
            return
        end = self.ptr + b
        if end <= self.size:
            self.queue[self.ptr:end] = batch
        else:
            first = self.size - self.ptr
            self.queue[self.ptr:] = batch[:first]
            self.queue[: end % self.size] = batch[first:]
        self.ptr = end % self.size
        self.filled = min(self.size, self.filled + b)

    def get(self) -> np.ndarray:
        return self.queue[: self.filled]


@dataclasses.dataclass
class DataAugmentation:
    cfg: AugmentConfig
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        if "gene_expr" in out and self.cfg.gene_dropout > 0:
            keep = self.rng.random(out["gene_expr"].shape) >= self.cfg.gene_dropout
            out["gene_expr"] = out["gene_expr"] * keep
        if "edge_mask" in out and self.cfg.edge_dropout > 0:
            drop = self.rng.random(out["edge_mask"].shape) < self.cfg.edge_dropout
            out["edge_mask"] = out["edge_mask"] & ~drop
        if "pert_values" in out and self.cfg.perturbation_noise > 0:
            out["pert_values"] = out["pert_values"] + (
                self.cfg.perturbation_noise
                * self.rng.normal(size=out["pert_values"].shape)
            ).astype(np.float32)
        return out


class TripleFlowDataset:
    """Cells + (optional) perturbations + (optional) protein embeddings.

    Subgraph batching: each batch samples cells, takes the induced subgraph
    from the precomputed kNN graph, pads nodes/edges to static shapes.
    """

    def __init__(
        self,
        cells: CellData,
        gene_to_esm: Optional[Dict[int, np.ndarray]] = None,
        protein_embeddings: Optional[np.ndarray] = None,
        n_top_degs: int = 10,
        n_neighbors: int = 15,
    ):
        if "edge_index" not in cells.uns:
            cells = compute_trajectory_info(cells, n_neighbors=n_neighbors)
        self.cells = cells
        self.conn = cells.uns["connectivities"]
        self.gene_to_esm = gene_to_esm
        self.protein_embeddings = protein_embeddings
        if "X_pert" in cells.layers:
            self.deg_idx, self.deg_vals = top_degs(
                cells.layers["X_pert"], n_top_degs // 2, n_top_degs - n_top_degs // 2
            )
        else:
            self.deg_idx = self.deg_vals = None

    def __len__(self) -> int:
        return self.cells.n_obs

    def batch(
        self, cell_ids: np.ndarray, max_edges_per_node: int = 16
    ) -> Dict[str, np.ndarray]:
        n = len(cell_ids)
        sub = self.conn[np.ix_(cell_ids, cell_ids)]
        src, dst = np.nonzero(sub)
        E = n * max_edges_per_node
        edge_index = np.zeros((2, E), np.int32)
        edge_mask = np.zeros(E, bool)
        k = min(len(src), E)
        edge_index[0, :k] = src[:k]
        edge_index[1, :k] = dst[:k]
        edge_mask[:k] = True

        out: Dict[str, np.ndarray] = {
            "gene_expr": self.cells.X[cell_ids],
            "dpt": self.cells.obs["dpt_pseudotime"][cell_ids].astype(np.float32),
            "edge_index": edge_index,
            "edge_mask": edge_mask,
            "batch_idx": np.zeros(n, np.int32),
        }
        if self.deg_idx is not None:
            idx = self.deg_idx[cell_ids]
            out["pert_values"] = self.deg_vals[cell_ids]
            if self.gene_to_esm is not None:
                esm = np.stack([
                    np.mean([self.gene_to_esm[g] for g in row], axis=0)
                    for row in idx
                ])
                out["pert_esm"] = esm.astype(np.float32)
            out["pert_gene_indices"] = idx
        if self.protein_embeddings is not None:
            out["protein_emb_raw"] = self.protein_embeddings[cell_ids]
        return out


class MultiModalBatch:
    """Collator: merge per-graph samples with edge offsets + batch indices,
    dropping modality keys absent from any sample (tong/utils/data.py:186-247)."""

    def __call__(self, samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        keys = set(samples[0])
        for s in samples[1:]:
            keys &= set(s)
        out: Dict[str, np.ndarray] = {}
        node_offsets = np.cumsum([0] + [s["gene_expr"].shape[0] for s in samples])
        if "edge_index" in keys:
            out["edge_index"] = np.concatenate(
                [s["edge_index"] + node_offsets[i] for i, s in enumerate(samples)],
                axis=1,
            ).astype(np.int32)
            if "edge_mask" in keys:
                out["edge_mask"] = np.concatenate([s["edge_mask"] for s in samples])
        out["batch_idx"] = np.concatenate(
            [np.full(s["gene_expr"].shape[0], i, np.int32) for i, s in enumerate(samples)]
        )
        # a plain python int: the segment ops take the graph count as a size
        out["num_graphs"] = len(samples)
        for k in keys - {"edge_index", "edge_mask", "batch_idx"}:
            out[k] = np.concatenate([s[k] for s in samples], axis=0)
        return out


def get_dataloader(
    dataset: TripleFlowDataset,
    batch_size: int,
    augment: Optional[DataAugmentation] = None,
    seed: int = 0,
    shuffle: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batched iterator over induced subgraphs (drops the ragged tail)."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n - batch_size + 1, batch_size):
        batch = dataset.batch(order[start : start + batch_size])
        if augment is not None:
            batch = augment(batch)
        yield batch
