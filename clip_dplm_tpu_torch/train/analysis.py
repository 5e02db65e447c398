"""Evaluation-time analysis suite, in numpy and PyTorch.

Counterpart of `clip_dplm_tpu/train/analysis.py`: confusion matrices and
per-pair class confusion rates, embedding collapse (mean intra-group
cosine), marker-space similarity, failure-case mining, cross-dataset
retrieval, hard-negative cache stats, the PCA spectrum of each embedding
space and a training-dynamics tracker, on the port's
`cosine_similarity_matrix`, `confusion_matrix`, `embedding_collapse` and
`retrieval_metrics` (train/metrics.py). Inputs are numpy arrays (or
tensors); the similarity matrices are formed on the CPU in f32 unless the
caller passes CUDA tensors.

`kmeans` is the analyze CLI's clustering (the JAX package calls
scikit-learn's `KMeans(n_clusters=k, n_init=4, random_state=0)`, which the
card's machine lacks), written in numpy after scikit-learn 1.9.0's
`KMeans` with `init="k-means++"` and the Lloyd algorithm.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clip_dplm_tpu_torch.ops.infonce import l2_normalize
from clip_dplm_tpu_torch.train.metrics import (
    confusion_matrix,
    cosine_similarity_matrix,
    embedding_collapse,
    retrieval_metrics,
)


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def compute_confusion_matrix(emb_a, emb_b, labels, n_classes: int) -> np.ndarray:
    """Class-level retrieval confusion: row = true class of the query, col =
    class of its top-1 retrieved item."""
    labels = np.asarray(labels)
    top1 = _np(cosine_similarity_matrix(_t(emb_a), _t(emb_b))).argmax(axis=1)
    pred = labels[top1]
    return _np(confusion_matrix(torch.as_tensor(pred), torch.as_tensor(labels), n_classes))


def analyze_cell_type_confusion(cm: np.ndarray,
                                class_names: Optional[Sequence[str]] = None
                                ) -> List[Dict[str, float]]:
    """Per-pair confusion rates, sorted: rate of class i retrieved as class
    j, off-diagonal, the nonzero ones."""
    norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    pairs = []
    k = cm.shape[0]
    for i in range(k):
        for j in range(k):
            if i != j and norm[i, j] > 0:
                pairs.append({
                    "true": class_names[i] if class_names else i,
                    "predicted": class_names[j] if class_names else j,
                    "rate": float(norm[i, j]),
                })
    return sorted(pairs, key=lambda p: -p["rate"])


def analyze_embedding_collapse(embeddings: Dict[str, np.ndarray], labels) -> Dict[str, float]:
    """Mean intra-group cosine per embedding space (higher = more
    collapsed)."""
    return {name: float(embedding_collapse(_t(e), _t(labels)))
            for name, e in embeddings.items()}


def marker_space_analysis(markers, emb) -> Dict[str, float]:
    """Correlation between the raw marker-space and the learned
    embedding-space similarity structures (upper triangles)."""
    sm = _np(cosine_similarity_matrix(_t(markers), _t(markers)))
    se = _np(cosine_similarity_matrix(_t(emb), _t(emb)))
    iu = np.triu_indices(sm.shape[0], k=1)
    corr = np.corrcoef(sm[iu], se[iu])[0, 1]
    return {"marker_embedding_similarity_corr": float(corr)}


def analyze_failure_cases(emb_a, emb_b, top_k: int = 10) -> List[Dict[str, float]]:
    """The worst retrieval failures: pairs whose positive similarity trails
    the best negative by the largest margin (positive margins only)."""
    sim = _np(cosine_similarity_matrix(_t(emb_a), _t(emb_b)))
    n = sim.shape[0]
    pos = sim[np.arange(n), np.arange(n)]
    masked = sim.copy()
    masked[np.arange(n), np.arange(n)] = -np.inf
    hardest = masked.argmax(axis=1)
    margin = masked.max(axis=1) - pos
    order = np.argsort(-margin)[:top_k]
    return [
        {
            "index": int(i),
            "positive_sim": float(pos[i]),
            "hardest_negative": int(hardest[i]),
            "hardest_negative_sim": float(masked[i, hardest[i]]),
            "margin": float(margin[i]),
        }
        for i in order
        if margin[i] > 0
    ]


def cross_dataset_analysis(encode_fn, datasets: Dict[str, Tuple[np.ndarray, np.ndarray]]
                           ) -> Dict[str, Dict[str, float]]:
    """Retrieval metrics per held-out dataset; `encode_fn(a, b)` gives the
    pair's (emb_a, emb_b)."""
    out = {}
    for name, (a, b) in datasets.items():
        emb_a, emb_b = encode_fn(a, b)
        out[name] = {k: float(v) for k, v in retrieval_metrics(_t(emb_a), _t(emb_b)).items()}
    return out


def hard_negative_cache_stats(emb_a, emb_b, cache, cache_len: int) -> Dict[str, float]:
    """Cache hit rate: how often a cache row outscores the in-batch best
    negative, and the mean query-to-cache similarity."""
    if cache_len == 0:
        return {"cache_hit_rate": 0.0, "cache_mean_sim": 0.0}
    a = _np(l2_normalize(_t(emb_a)))
    b = _np(l2_normalize(_t(emb_b)))
    c = np.asarray(cache)[:cache_len]
    sim_batch = a @ b.T
    np.fill_diagonal(sim_batch, -np.inf)
    best_batch = sim_batch.max(axis=1)
    sim_cache = a @ c.T
    best_cache = sim_cache.max(axis=1)
    return {
        "cache_hit_rate": float((best_cache > best_batch).mean()),
        "cache_mean_sim": float(sim_cache.mean()),
    }


def analyze_embedding_distributions(embeddings: Dict[str, np.ndarray], n_components: int = 10
                                    ) -> Dict[str, Dict[str, float]]:
    """PCA spectrum stats per space, in f64: effective rank,
    explained-variance concentration, feature-norm stats."""
    out = {}
    for name, e in embeddings.items():
        e = np.asarray(e, np.float64)
        e = e - e.mean(axis=0)
        cov_eigs = np.linalg.eigvalsh(np.cov(e, rowvar=False))[::-1]
        cov_eigs = np.maximum(cov_eigs, 0)
        p = cov_eigs / max(cov_eigs.sum(), 1e-12)
        eff_rank = float(np.exp(-(p * np.log(np.maximum(p, 1e-12))).sum()))
        out[name] = {
            "effective_rank": eff_rank,
            "top1_explained_variance": float(p[0]),
            f"top{n_components}_explained_variance": float(p[:n_components].sum()),
            "mean_norm": float(np.linalg.norm(e, axis=1).mean()),
        }
    return out


class TrainingDynamicsTracker:
    """Accumulates per-step scalars; moving averages over `window`, the
    best value of each and the steps since it."""

    def __init__(self, window: int = 50):
        self.window = window
        self.history: Dict[str, List[float]] = {}
        self.best: Dict[str, float] = {}
        self.steps_since_best: Dict[str, int] = {}

    def update(self, metrics: Dict[str, float]) -> Dict[str, float]:
        smoothed = {}
        for k, v in metrics.items():
            v = float(v)
            self.history.setdefault(k, []).append(v)
            smoothed[k] = float(np.mean(self.history[k][-self.window:]))
            if k not in self.best or v < self.best[k]:
                self.best[k] = v
                self.steps_since_best[k] = 0
            else:
                self.steps_since_best[k] += 1
        return smoothed

    def improved(self, key: str) -> bool:
        return self.steps_since_best.get(key, 0) == 0


# ---------------------------------------------------------------------------
# k-means (scikit-learn 1.9.0's KMeans, init="k-means++", algorithm="lloyd")
# ---------------------------------------------------------------------------


def _sq_dists_upcast(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Squared Euclidean distances of f32 rows as scikit-learn's
    `euclidean_distances` forms them: -2·x·y^T + |x|² + |y|² in f64, cast
    to x's dtype, clamped at 0."""
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    d = -2 * (x64 @ y64.T)
    d += np.einsum("ij,ij->i", x64, x64)[:, None]
    d += np.einsum("ij,ij->i", y64, y64)[None, :]
    return np.maximum(d.astype(x.dtype), 0)


def _kmeans_plusplus(x, n_clusters, weight, rs):
    """k-means++ seeding with 2 + floor(ln k) local trials a center."""
    n = x.shape[0]
    trials = 2 + int(np.log(n_clusters))
    centers = np.empty((n_clusters, x.shape[1]), dtype=x.dtype)
    first = rs.choice(n, p=weight / weight.sum())
    centers[0] = x[first]
    closest = _sq_dists_upcast(x[[first]], x)
    pot = closest @ weight
    for c in range(1, n_clusters):
        rand = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(weight * closest), rand)
        np.clip(cand, None, closest.size - 1, out=cand)
        d = _sq_dists_upcast(x[cand], x)
        np.minimum(closest, d, out=d)
        pots = d @ weight.reshape(-1, 1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], d[best]
        centers[c] = x[cand[best]]
    return centers


def _assign(x, centers):
    """Labels: argmin over centers of |c|² - 2·x·c (the first on ties)."""
    d = (centers * centers).sum(axis=1)[None, :] + (-2.0 * (x @ centers.T)).astype(x.dtype)
    return d.argmin(axis=1).astype(np.int32)


def _lloyd(x, weight, centers, max_iter, tol):
    """Lloyd's iterations to strict convergence (labels unchanged) or a total
    squared center shift within `tol`; empty clusters relocated to the
    samples farthest from their centers, as scikit-learn does. Returns
    (labels, inertia, centers)."""
    k = centers.shape[0]
    labels_old = np.full(x.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(max_iter):
        labels = _assign(x, centers)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, x * weight[:, None])
        wsum = np.bincount(labels, weights=weight, minlength=k).astype(x.dtype)
        empty = np.flatnonzero(wsum == 0)
        if empty.size:
            dist = ((x - centers[labels]) ** 2).sum(axis=1)
            if dist.max() > 0:
                far = np.argpartition(dist, -empty.size)[:-empty.size - 1:-1]
                for new_id, idx in zip(empty, far):
                    old_id = labels[idx]
                    sums[old_id] -= x[idx] * weight[idx]
                    sums[new_id] = x[idx] * weight[idx]
                    wsum[new_id] = weight[idx]
                    wsum[old_id] -= weight[idx]
        big, one = int(np.argmax(wsum)), x.dtype.type(1.0)
        for j in range(k):  # in place and in order, as scikit-learn averages
            sums[j] = sums[j] * (one / wsum[j]) if wsum[j] > 0 else sums[big]
        shift = np.sqrt(((sums - centers) ** 2).sum(axis=1))
        centers = sums
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)
    inertia = (((x - centers[labels]) ** 2).sum(axis=1) * weight).sum()
    return labels, inertia, centers


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    mapping = np.full(k, -1)
    for i, j in zip(a, b):
        if mapping[i] == -1:
            mapping[i] = j
        elif mapping[i] != j:
            return False
    return True


def kmeans(x, n_clusters: int, n_init: int = 4, random_state: int = 0, max_iter: int = 300,
           tol: float = 1e-4) -> Tuple[np.ndarray, np.ndarray, float]:
    """(labels, centers, inertia) of k-means on the rows of x, as
    `sklearn.cluster.KMeans(n_clusters, n_init=n_init,
    random_state=random_state).fit(x)` computes them: f32 inputs stay f32
    (else f64); x is centred on its mean; tol is scaled by the mean feature
    variance; each of n_init runs is seeded by k-means++ from one
    `np.random.RandomState(random_state)`, in scikit-learn's order of
    draws, then Lloyd's iterations; the run of least inertia wins (a later
    run only when its clustering differs)."""
    x = np.array(x, dtype=np.float32 if np.asarray(x).dtype == np.float32 else np.float64)
    tol = float(np.mean(np.var(x, axis=0)) * tol)
    mean = x.mean(axis=0)
    x -= mean
    weight = np.ones(x.shape[0], dtype=x.dtype)
    rs = np.random.RandomState(random_state)
    best = None
    for _ in range(n_init):
        centers = _kmeans_plusplus(x, n_clusters, weight, rs)
        labels, inertia, centers = _lloyd(x, weight, centers, max_iter, tol)
        if best is None or (inertia < best[1]
                            and not _same_clustering(labels, best[0], n_clusters)):
            best = (labels, inertia, centers)
    labels, inertia, centers = best
    return labels, centers + mean, float(inertia)
