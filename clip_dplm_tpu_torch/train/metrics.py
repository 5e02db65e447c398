"""Evaluation metrics: bidirectional retrieval over a paired eval set.

Counterpart of the retrieval part of `clip_dplm_tpu/train/metrics.py`
(`cosine_similarity_matrix`, `retrieval_metrics`), the BASELINE.json
headline R@1 / R@10. Plain tensor ops on the embeddings' device; the flow
and biological metrics of that module are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from clip_dplm_tpu_torch.ops.infonce import l2_normalize


def cosine_similarity_matrix(emb_a: torch.Tensor, emb_b: torch.Tensor) -> torch.Tensor:
    """(N, M) cosine similarities in f32."""
    return l2_normalize(emb_a) @ l2_normalize(emb_b).t()


def _ranks(sim: torch.Tensor) -> torch.Tensor:
    """Rank of each row's diagonal entry in the row sorted in descending
    order (stable, ties broken by column index), as JAX's argsort does."""
    labels = torch.arange(sim.shape[0], device=sim.device)
    order = torch.argsort(-sim, dim=-1, stable=True)
    return (order == labels[:, None]).int().argmax(dim=-1)


@torch.no_grad()
def retrieval_metrics(emb_a: torch.Tensor, emb_b: torch.Tensor) -> Dict[str, torch.Tensor]:
    """R@1/5/10 in each direction (a->b rows, b->a columns) and their mean,
    matching accuracy and mean rank over N pairs whose positives lie on the
    diagonal; 0-d f32 tensors on the embeddings' device."""
    sim = cosine_similarity_matrix(emb_a, emb_b)
    labels = torch.arange(sim.shape[0], device=sim.device)
    r_ab, r_ba = _ranks(sim), _ranks(sim.t())
    out = {}
    for k in (1, 5, 10):
        ab, ba = (r_ab < k).float().mean(), (r_ba < k).float().mean()
        out[f"R@{k}_ab"], out[f"R@{k}_ba"], out[f"R@{k}"] = ab, ba, 0.5 * (ab + ba)
    out["accuracy"] = 0.5 * ((sim.argmax(dim=-1) == labels).float().mean()
                             + (sim.t().argmax(dim=-1) == labels).float().mean())
    out["mean_rank"] = 0.5 * (r_ab.float().mean() + r_ba.float().mean())
    return out
