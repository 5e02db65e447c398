"""Host-side single-cell data structures and trajectory preprocessing.

A copy of `clip_dplm_tpu/data/cells.py` (numpy on the host; the port keeps
its own copy so that it imports nothing of the JAX package):
- `CellData`: a minimal AnnData-like container (X, obs, obsm, layers, uns)
  with `.npz` save/load; `.h5ad` reading is gated on `anndata`;
- `knn_graph`: the kNN connectivity and its COO edge_index;
- `diffusion_map` / `diffusion_pseudotime` (DPT from a root cell);
- `leiden_clusters`, `modularity`, `paga_connectivities`, `cluster_graph`;
- `top_degs`, `select_hvg`, `one_hot_labels`.
Every function but `knn_graph` is the reference's, line for line. The
reference's `knn_graph` takes scikit-learn's brute-force `NearestNeighbors`,
which the port does not depend on; the port computes the same thing the
same way: squared norms by BLAS `ddot` on the rows upcast to f64, the
middle term -2 x.y by an f64 matrix product, the surrogate squared distance
(|x|^2 + -2 x.y) + |y|^2 clamped at 0, the k + 1 nearest sorted by it, and
the distance as the f32 square root of the f32-rounded surrogate. On the
synthetic cells the tests use (up to 1024 x 2000) the graph equals
scikit-learn's bit for bit; a distance could differ in its last f32 bit
where the two libraries' matrix products sum in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CellData:
    """Minimal AnnData-equivalent: cells x genes + annotations."""

    X: np.ndarray  # (n_cells, n_genes) dense float32
    obs: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    obsm: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    layers: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    uns: Dict[str, object] = dataclasses.field(default_factory=dict)
    var_names: Optional[np.ndarray] = None

    @property
    def n_obs(self) -> int:
        return self.X.shape[0]

    @property
    def n_vars(self) -> int:
        return self.X.shape[1]

    @classmethod
    def read_h5ad(cls, path: str) -> "CellData":
        try:
            import anndata  # gated: not installed in this image
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "reading .h5ad requires the `anndata` package; preprocess to "
                ".npz with CellData.save/load instead"
            ) from e
        a = anndata.read_h5ad(path)
        X = np.asarray(a.X.todense() if hasattr(a.X, "todense") else a.X,
                       dtype=np.float32)
        return cls(
            X=X,
            obs={k: np.asarray(v) for k, v in a.obs.items()},
            obsm={k: np.asarray(v) for k, v in a.obsm.items()},
            layers={k: np.asarray(
                v.todense() if hasattr(v, "todense") else v, dtype=np.float32)
                for k, v in a.layers.items()},
            var_names=np.asarray(a.var_names),
        )

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, X=self.X,
            **{f"obs_{k}": v for k, v in self.obs.items()},
            **{f"obsm_{k}": v for k, v in self.obsm.items()},
            **{f"layers_{k}": v for k, v in self.layers.items()},
        )

    @classmethod
    def load(cls, path: str) -> "CellData":
        z = np.load(path, allow_pickle=False)
        obs, obsm, layers = {}, {}, {}
        for k in z.files:
            if k.startswith("obs_"):
                obs[k[4:]] = z[k]
            elif k.startswith("obsm_"):
                obsm[k[5:]] = z[k]
            elif k.startswith("layers_"):
                layers[k[7:]] = z[k]
        return cls(X=z["X"], obs=obs, obsm=obsm, layers=layers)

    @classmethod
    def synthetic(
        cls, n_cells: int = 200, n_genes: int = 100, n_types: int = 4,
        n_branches: int = 2, seed: int = 0,
    ) -> "CellData":
        """Trajectory-structured fake cells: branches in gene space with a
        latent progression coordinate, perturbation labels, and markers."""
        rng = np.random.default_rng(seed)
        progression = rng.random(n_cells).astype(np.float32)
        branch = rng.integers(0, n_branches, n_cells)
        cell_type = rng.integers(0, n_types, n_cells)
        directions = rng.normal(size=(n_branches, n_genes)).astype(np.float32)
        base = rng.normal(size=(n_genes,)).astype(np.float32)
        X = (
            base[None, :]
            + progression[:, None] * directions[branch]
            + 0.3 * rng.normal(size=(n_cells, n_genes)).astype(np.float32)
        )
        pert_genes = rng.integers(0, n_genes, n_cells)
        pert_layer = 0.2 * rng.normal(size=(n_cells, n_genes)).astype(np.float32)
        pert_layer[np.arange(n_cells), pert_genes] += 3.0 * rng.choice(
            [-1.0, 1.0], n_cells
        ).astype(np.float32)
        is_ctrl = rng.random(n_cells) < 0.2
        return cls(
            X=X.astype(np.float32),
            obs={
                "cell_type": cell_type,
                "perturbation_gene": pert_genes,
                "mixscape_class": np.where(is_ctrl, 0, 1 + branch),
                "progression": progression,
            },
            layers={"X_pert": pert_layer},
        )


# ---------------------------------------------------------------------------
# graph + trajectory preprocessing (one-time, host)
# ---------------------------------------------------------------------------


def knn_graph(
    X: np.ndarray, n_neighbors: int = 15, include_self: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric kNN graph. Returns (edge_index (2, E), connectivities
    (n, n) dense float32)."""
    dist, idx = _nearest(X, n_neighbors + 1)
    n = X.shape[0]
    conn = np.zeros((n, n), np.float32)
    # gaussian-ish kernel on distances (scanpy umap-connectivity flavored)
    sigma = np.maximum(dist[:, 1:].mean(axis=1, keepdims=True), 1e-8)
    w = np.exp(-((dist / sigma) ** 2))
    for i in range(n):
        start = 0 if include_self else 1
        conn[i, idx[i, start:]] = w[i, start:]
    conn = np.maximum(conn, conn.T)  # symmetrize
    src, dst = np.nonzero(conn)
    return np.stack([src, dst]).astype(np.int64), conn


def _nearest(X: np.ndarray, k: int, rows: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """(distances (n, k) f64, indices (n, k) int64) of the k nearest rows of
    X to each row, itself included, nearest first: scikit-learn's
    brute-force euclidean kneighbors for f32 data (see the module
    docstring), `rows` query rows at a time."""
    from scipy.linalg.blas import ddot

    X64 = np.ascontiguousarray(X, dtype=np.float32).astype(np.float64)
    norms = np.array([ddot(r, r) for r in X64])
    n = X64.shape[0]
    dist = np.empty((n, k), np.float64)
    idx = np.empty((n, k), np.int64)
    for s in range(0, n, rows):
        middle = -2.0 * (X64[s:s + rows] @ X64.T)
        d2 = np.maximum((norms[s:s + rows, None] + middle) + norms[None, :], 0.0)
        order = np.argsort(d2, axis=1, kind="stable")[:, :k]
        idx[s:s + rows] = order
        near = np.take_along_axis(d2, order, axis=1).astype(np.float32)
        dist[s:s + rows] = np.sqrt(near).astype(np.float64)
    return dist, idx


def diffusion_map(
    conn: np.ndarray, n_comps: int = 10
) -> Tuple[np.ndarray, np.ndarray]:
    """Diffusion-map coordinates from a connectivity matrix.

    Symmetrized transition operator M = D^-1/2 K D^-1/2; eigenvectors 1..n
    scaled by eigenvalues give `X_diffmap` (sc.tl.diffmap semantics)."""
    d = np.maximum(conn.sum(axis=1), 1e-12)
    dinv_sqrt = 1.0 / np.sqrt(d)
    M = conn * dinv_sqrt[:, None] * dinv_sqrt[None, :]
    vals, vecs = np.linalg.eigh(M)
    order = np.argsort(-vals)
    vals, vecs = vals[order], vecs[:, order]
    # drop the trivial first component; scale by eigenvalue
    comps = vecs[:, 1 : n_comps + 1] * vals[1 : n_comps + 1][None, :]
    return comps.astype(np.float32), vals[: n_comps + 1].astype(np.float32)


def diffusion_pseudotime(
    conn: np.ndarray, root: int, n_comps: int = 10
) -> np.ndarray:
    """DPT: distance to the root cell in diffusion-component space, scaled by
    lambda/(1-lambda) per component (sc.tl.dpt semantics; root = first CTRL
    cell per tong/utils/data.py:41-46 / tf nb cell 10)."""
    comps, vals = diffusion_map(conn, n_comps)
    lam = np.clip(vals[1 : n_comps + 1], 0.0, 1.0 - 1e-6)
    scale = lam / (1.0 - lam)
    scaled = comps * scale[None, :]
    d = np.linalg.norm(scaled - scaled[root : root + 1], axis=1)
    dmax = d.max()
    return (d / dmax if dmax > 0 else d).astype(np.float32)


def compute_trajectory_info(
    cells: CellData, n_neighbors: int = 15, n_comps: int = 10,
    ctrl_key: str = "mixscape_class", ctrl_value: int = 0,
) -> CellData:
    """The `compute_paga_dpt` / `_compute_trajectory_info` pipeline:
    neighbors -> diffmap -> DPT with a CTRL-cell root; results land in
    obsm/obs/uns like scanpy would put them."""
    edge_index, conn = knn_graph(cells.X, n_neighbors)
    comps, _ = diffusion_map(conn, n_comps)
    ctrl = np.nonzero(cells.obs.get(ctrl_key, np.zeros(cells.n_obs)) == ctrl_value)[0]
    root = int(ctrl[0]) if len(ctrl) else 0
    dpt = diffusion_pseudotime(conn, root, n_comps)
    leiden = leiden_clusters(conn)
    cells.obsm["X_diffmap"] = comps
    cells.obs["dpt_pseudotime"] = dpt
    cells.obs["leiden"] = leiden
    cells.uns["edge_index"] = edge_index
    cells.uns["connectivities"] = conn
    cells.uns["iroot"] = root
    cells.uns["paga"] = {
        "connectivities": paga_connectivities(conn, leiden),
        "groups": "leiden",
    }
    return cells


def leiden_clusters(
    conn: np.ndarray,
    resolution: float = 1.0,
    seed: int = 0,
    max_iters: int = 20,
) -> np.ndarray:
    """Graph-modularity clustering of a weighted connectivity matrix —
    native equivalent of `sc.tl.leiden` (tf nb cells 8-12,
    tong/utils/data.py:36-49; scanpy shells out to leidenalg, absent here).

    Louvain-style greedy local moving with one coarsening level: each node
    moves to the neighboring community with the largest modularity gain

        dQ = w(i, C) - resolution * k_i * sum_C / (2m)

    until no move improves Q, then communities are contracted and the local
    moving repeats on the coarse graph. Deterministic given `seed`.
    Returns int32 labels, compacted to 0..k-1.
    """
    rng = np.random.default_rng(seed)

    def local_moving(W: np.ndarray, labels: np.ndarray) -> np.ndarray:
        n = W.shape[0]
        k_deg = W.sum(axis=1)
        two_m = max(k_deg.sum(), 1e-12)
        sum_tot = np.zeros(labels.max() + 1)
        np.add.at(sum_tot, labels, k_deg)
        improved = True
        it = 0
        while improved and it < max_iters:
            improved = False
            it += 1
            for i in rng.permutation(n):
                c_old = labels[i]
                sum_tot[c_old] -= k_deg[i]
                # weight from i into each candidate community (its neighbors')
                nbrs = np.nonzero(W[i])[0]
                cand = np.unique(labels[nbrs]) if len(nbrs) else np.array([c_old])
                w_in = np.zeros(len(cand))
                for j, c in enumerate(cand):
                    w_in[j] = W[i, nbrs[labels[nbrs] == c]].sum()
                gain = w_in - resolution * k_deg[i] * sum_tot[cand] / two_m
                # staying put is always a candidate
                stay = np.nonzero(cand == c_old)[0]
                best = int(cand[np.argmax(gain)])
                if len(stay) and gain[stay[0]] >= gain.max() - 1e-12:
                    best = c_old
                if best != c_old:
                    labels[i] = best
                    improved = True
                sum_tot[labels[i]] += k_deg[i]
        return labels

    n = conn.shape[0]
    W = conn.astype(np.float64)
    np.fill_diagonal(W, 0.0)
    labels = local_moving(W, np.arange(n, dtype=np.int64))
    # one level of contraction + re-moving (captures most of leiden's gain
    # over plain label propagation on kNN graphs of this size)
    _, compact = np.unique(labels, return_inverse=True)
    k = compact.max() + 1
    agg = np.zeros((k, k))
    np.add.at(agg, (compact[:, None], compact[None, :]), W)
    coarse = local_moving(agg, np.arange(k, dtype=np.int64))
    labels = coarse[compact]
    _, out = np.unique(labels, return_inverse=True)
    return out.astype(np.int32)


def modularity(conn: np.ndarray, labels: np.ndarray, resolution: float = 1.0) -> float:
    """Newman modularity Q of a labeling (test oracle for leiden_clusters)."""
    W = conn.astype(np.float64).copy()
    np.fill_diagonal(W, 0.0)
    two_m = max(W.sum(), 1e-12)
    k_deg = W.sum(axis=1)
    q = 0.0
    for c in np.unique(labels):
        m = labels == c
        q += W[np.ix_(m, m)].sum() / two_m
        q -= resolution * (k_deg[m].sum() / two_m) ** 2
    return float(q)


def paga_connectivities(
    conn: np.ndarray, labels: np.ndarray, n_clusters: Optional[int] = None
) -> np.ndarray:
    """PAGA cluster-graph connectivity (sc.tl.paga v1.2 statistic): observed
    inter-cluster edge weight over its expectation under the configuration
    model, clipped to [0, 1].

        c_ij = w_ij / (s_i * s_j / (2m))   (0 on the diagonal)

    High c_ij = the trajectory continues between clusters i and j; this is
    the trajectory-topology map the reference computes via scanpy (tf nb
    cells 8-12) and reads for branch structure."""
    k = n_clusters or int(labels.max()) + 1
    W = conn.astype(np.float64).copy()
    np.fill_diagonal(W, 0.0)
    two_m = max(W.sum(), 1e-12)
    agg = np.zeros((k, k))
    np.add.at(agg, (labels[:, None], labels[None, :]), W)
    s = agg.sum(axis=1)  # cluster degree
    expected = np.outer(s, s) / two_m
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(expected > 0, agg / expected, 0.0)
    np.fill_diagonal(c, 0.0)
    return np.clip(c, 0.0, 1.0).astype(np.float32)


def cluster_graph(
    conn: np.ndarray, labels: np.ndarray, n_clusters: Optional[int] = None
) -> np.ndarray:
    """PAGA-like coarse connectivity: mean edge weight between clusters."""
    k = n_clusters or int(labels.max()) + 1
    out = np.zeros((k, k), np.float32)
    counts = np.zeros((k, k), np.float32)
    for a in range(k):
        ma = labels == a
        for b in range(k):
            mb = labels == b
            block = conn[np.ix_(ma, mb)]
            if block.size:
                out[a, b] = block.sum()
                counts[a, b] = block.size
    return out / np.maximum(counts, 1.0)


def top_degs(
    pert_layer: np.ndarray, k_up: int = 5, k_down: int = 5
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell top-k up + top-k down DEGs, values min-max scaled to [-1, 1]
    (tf nb cell 29 `get_top_degs` + scaling)."""
    n, g = pert_layer.shape
    up = np.argsort(-pert_layer, axis=1)[:, :k_up]
    down = np.argsort(pert_layer, axis=1)[:, :k_down]
    idx = np.concatenate([up, down], axis=1)  # (n, k_up + k_down)
    vals = np.take_along_axis(pert_layer, idx, axis=1)
    vmax = np.abs(vals).max(axis=1, keepdims=True)
    vals = vals / np.maximum(vmax, 1e-8)  # symmetric min-max into [-1, 1]
    return idx.astype(np.int32), vals.astype(np.float32)


def select_hvg(X: np.ndarray, n_top_genes: int = 2000) -> np.ndarray:
    """Indices of the highest-variance genes (HVG selection capability)."""
    var = X.var(axis=0)
    k = min(n_top_genes, X.shape[1])
    return np.argsort(-var)[:k].astype(np.int64)


def one_hot_labels(labels: np.ndarray, n_classes: Optional[int] = None) -> np.ndarray:
    """One-hot encode class labels (the `mixscape_class` export of tf nb
    cell 29 preprocess_data)."""
    labels = np.asarray(labels, np.int64)
    k = n_classes or int(labels.max()) + 1
    out = np.zeros((labels.shape[0], k), np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out
