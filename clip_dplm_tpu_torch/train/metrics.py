"""Evaluation metrics: bidirectional retrieval over a paired eval set and
the distribution metrics of generated flows.

Counterpart of `clip_dplm_tpu/train/metrics.py`: `cosine_similarity_matrix`
and `retrieval_metrics` (the BASELINE.json headline R@1 / R@10), and the
flow metrics `wasserstein2_gaussian` (the Gaussian W2^2, matrix square
roots by `torch.linalg.eigh`), `frechet_distance`, `mmd_rbf`,
`sliced_wasserstein` (random unit projections: the caller's (d, n_proj)
matrix, or one drawn from a CPU generator, so the card and the CPU project
alike) and `FlowEvaluator`. Plain tensor ops on the inputs' device, in f32
(f64 for f64 inputs); and the evaluate CLI's `BiologicalMetrics`,
`embedding_collapse` and `confusion_matrix`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from clip_dplm_tpu_torch.ops.infonce import at_least_f32, l2_normalize


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


# ---------------------------------------------------------------------------
# distribution metrics of flows (wasserstein / mmd / fid)
# ---------------------------------------------------------------------------


def _sqrtm_psd(m: torch.Tensor) -> torch.Tensor:
    w, v = torch.linalg.eigh(m)
    w = torch.clamp(w, min=0.0)
    return (v * torch.sqrt(w)[None, :]) @ v.t()


def wasserstein2_gaussian(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Gaussian (Bures) W2^2 between two sample sets: |mu_x - mu_y|^2 +
    Tr(Cx + Cy - 2 (Cx^1/2 Cy Cx^1/2)^1/2), each covariance + 1e-6 I."""
    x, y = at_least_f32(x), at_least_f32(y)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    cx = torch.cov(x.t()) + 1e-6 * eye
    cy = torch.cov(y.t()) + 1e-6 * eye
    sqrt_cx = _sqrtm_psd(cx)
    cross = _sqrtm_psd(sqrt_cx @ cy @ sqrt_cx)
    return torch.sum((x.mean(0) - y.mean(0)) ** 2) + torch.trace(cx + cy - 2.0 * cross)


def frechet_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """FID-style Frechet distance: the Gaussian W2^2 in embedding space."""
    return wasserstein2_gaussian(x, y)


def mmd_rbf(x: torch.Tensor, y: torch.Tensor,
            bandwidths: Sequence[float] = (1.0, 2.0, 4.0, 8.0)) -> torch.Tensor:
    """Multi-bandwidth RBF MMD^2 (the unbiased off-diagonal estimator),
    averaged over the bandwidths."""
    x, y = at_least_f32(x), at_least_f32(y)

    def pdist2(u, v):
        return torch.sum(u * u, 1)[:, None] + torch.sum(v * v, 1)[None, :] - 2.0 * (u @ v.t())

    dxx, dyy, dxy = pdist2(x, x), pdist2(y, y), pdist2(x, y)
    n, m = x.shape[0], y.shape[0]
    total = x.new_zeros(())
    for bw in bandwidths:
        kxx, kyy, kxy = (torch.exp(-dd / (2 * bw * bw)) for dd in (dxx, dyy, dxy))
        exx = (kxx.sum() - torch.trace(kxx)) / (n * (n - 1))
        eyy = (kyy.sum() - torch.trace(kyy)) / (m * (m - 1))
        total = total + exx + eyy - 2.0 * kxy.mean()
    return total / len(bandwidths)


def sliced_wasserstein(x: torch.Tensor, y: torch.Tensor, n_proj: int = 64,
                       proj: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sliced W2: the mean squared difference of the sorted 1-D projections
    onto unit columns. `proj` (d, n_proj) is taken as given (then
    normalized); without it the columns are drawn on the CPU from
    `generator` (a CPU generator, seeded 0 when none is given)."""
    if proj is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        proj = torch.randn(x.shape[1], n_proj, generator=gen)
    proj = at_least_f32(proj)
    proj = proj / torch.linalg.vector_norm(proj, dim=0, keepdim=True)
    x, y = at_least_f32(x), at_least_f32(y)
    proj = proj.to(device=x.device, dtype=x.dtype)
    px = torch.sort(x @ proj, dim=0).values
    py = torch.sort(y @ proj, dim=0).values
    return torch.mean((px - py) ** 2)


class FlowEvaluator:
    """Flow-quality metrics over (generated, target) samples: `wasserstein`
    (sliced, from `seed`'s projections), `mmd` and `fid`, as floats."""

    def __init__(self, metrics: Sequence[str] = ("wasserstein", "mmd", "fid"), seed: int = 0):
        self.metrics, self.seed = tuple(metrics), seed

    @torch.no_grad()
    def compute_all_metrics(self, generated: torch.Tensor,
                            target: torch.Tensor) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if "wasserstein" in self.metrics:
            gen = torch.Generator().manual_seed(self.seed)
            out["wasserstein"] = float(sliced_wasserstein(generated, target, generator=gen))
        if "mmd" in self.metrics:
            out["mmd"] = float(mmd_rbf(generated, target))
        if "fid" in self.metrics:
            out["fid"] = float(frechet_distance(generated, target))
        return out


# ---------------------------------------------------------------------------
# embedding-space metrics of the evaluate CLI
# ---------------------------------------------------------------------------


class BiologicalMetrics:
    """Embedding-space metrics of a paired eval set: the retrieval metrics
    of the whole set and, given class labels, the collapse of each side."""

    @torch.no_grad()
    def compute_all_metrics(self, emb_a, emb_b, labels=None) -> Dict[str, float]:
        """emb_a, emb_b (N, d) and labels (N,): tensors (computed on their
        device) or arrays (on the CPU); floats out."""
        emb_a, emb_b = torch.as_tensor(emb_a), torch.as_tensor(emb_b)
        out = {k: float(v) for k, v in retrieval_metrics(emb_a, emb_b).items()}
        if labels is not None:
            labels = torch.as_tensor(labels)
            out["embedding_collapse_a"] = float(embedding_collapse(emb_a, labels.to(emb_a.device)))
            out["embedding_collapse_b"] = float(embedding_collapse(emb_b, labels.to(emb_b.device)))
        return out


def embedding_collapse(emb: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cosine similarity over the pairs of distinct rows that share a
    label (higher is more collapsed); 0 when no two rows share one."""
    z = l2_normalize(emb)
    sim = z @ z.t()
    n = sim.shape[0]
    mask = (labels[:, None] == labels[None, :]) & ~torch.eye(n, dtype=torch.bool,
                                                              device=sim.device)
    return torch.sum(sim * mask) / torch.clamp(torch.sum(mask), min=1)


def confusion_matrix(pred: torch.Tensor, true: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(n_classes, n_classes) int32 counts, rows the true class: one
    bincount over true * n_classes + pred."""
    idx = true.long() * n_classes + pred.long()
    flat = torch.bincount(idx, minlength=n_classes * n_classes)
    return flat[:n_classes * n_classes].to(torch.int32).reshape(n_classes, n_classes)
