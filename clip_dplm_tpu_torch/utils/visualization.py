"""Figures (matplotlib, the headless Agg backend).

Counterpart of `clip_dplm_tpu/utils/visualization.py`: a `Visualizer`
writing PNGs of embedding scatters (t-SNE or PCA per space), a flow
vector field, an attention heatmap, train/val curves, a cosine-similarity
heatmap and a latent trajectory. matplotlib is imported when a
`Visualizer` is built, never when this module is imported, and
scikit-learn's TSNE only when `plot_embeddings` is asked for t-SNE: a
machine without them runs everything else of the package, and a missing
one raises an ImportError that names it (`require`).
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

PACKAGES = {"matplotlib": "matplotlib", "sklearn": "scikit-learn"}


def missing(*modules: str) -> List[str]:
    """The pip names of the modules among `modules` that do not import."""
    out = []
    for m in modules:
        try:
            importlib.import_module(m)
        except ImportError:
            out.append(PACKAGES.get(m, m))
    return out


def require(module: str, what: str):
    """Import `module`, or raise an ImportError naming its package."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs {PACKAGES.get(module, module)}, which is not "
                          f"installed") from e


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x)


class Visualizer:
    def __init__(self, out_dir: str = "runs/figures"):
        matplotlib = require("matplotlib", "Visualizer")
        matplotlib.use("Agg")
        self._plt = require("matplotlib.pyplot", "Visualizer")
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _save(self, fig, name: str) -> str:
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        self._plt.close(fig)
        return path

    def plot_embeddings(self, embeddings: Dict[str, np.ndarray],
                        labels: Optional[np.ndarray] = None, name: str = "embeddings",
                        method: str = "tsne") -> str:
        """2-D t-SNE (scikit-learn, PCA init, perplexity min(30, max(2, n //
        4))) or PCA scatter per embedding space; PCA below 6 rows."""
        spaces = list(embeddings)
        fig, axes = self._plt.subplots(1, len(spaces), figsize=(5 * len(spaces), 4.2),
                                       squeeze=False)
        for ax, space in zip(axes[0], spaces):
            e = _to_numpy(embeddings[space]).astype(np.float64)
            if method == "tsne" and e.shape[0] > 5:
                TSNE = require("sklearn.manifold", "plot_embeddings(method='tsne')").TSNE
                xy = TSNE(n_components=2, init="pca",
                          perplexity=min(30, max(2, e.shape[0] // 4))).fit_transform(e)
            else:
                e = e - e.mean(0)
                _, _, vt = np.linalg.svd(e, full_matrices=False)
                xy = e @ vt[:2].T
            sc = ax.scatter(xy[:, 0], xy[:, 1], c=labels, cmap="tab10", s=12)
            ax.set_title(space)
            if labels is not None:
                fig.colorbar(sc, ax=ax, shrink=0.8)
        return self._save(fig, name)

    def plot_flow_field(self, velocity_fn, bounds: Sequence[float] = (-3, 3, -3, 3),
                        grid: int = 20, t: float = 0.5, name: str = "flow_field") -> str:
        """Quiver of a 2-D flow; velocity_fn maps (N, 2) points and (N,)
        times to (N, 2) velocities."""
        xs = np.linspace(bounds[0], bounds[1], grid)
        ys = np.linspace(bounds[2], bounds[3], grid)
        xx, yy = np.meshgrid(xs, ys)
        pts = np.stack([xx.ravel(), yy.ravel()], axis=1).astype(np.float32)
        v = _to_numpy(velocity_fn(pts, np.full(pts.shape[0], t, np.float32)))
        fig, ax = self._plt.subplots(figsize=(5.5, 5))
        ax.quiver(pts[:, 0], pts[:, 1], v[:, 0], v[:, 1], np.linalg.norm(v, axis=1),
                  cmap="viridis")
        ax.set_title(f"flow field (t={t})")
        return self._save(fig, name)

    def plot_attention_weights(self, weights: np.ndarray, name: str = "attention",
                               x_labels: Optional[Sequence[str]] = None,
                               y_labels: Optional[Sequence[str]] = None) -> str:
        """Attention heatmap."""
        fig, ax = self._plt.subplots(figsize=(6, 5))
        im = ax.imshow(_to_numpy(weights), aspect="auto", cmap="magma")
        fig.colorbar(im, ax=ax)
        if x_labels is not None:
            ax.set_xticks(range(len(x_labels)), x_labels, rotation=90, fontsize=6)
        if y_labels is not None:
            ax.set_yticks(range(len(y_labels)), y_labels, fontsize=6)
        return self._save(fig, name)

    def plot_training_progress(self, history: Dict[str, Sequence[float]],
                               name: str = "training") -> str:
        """Train/val metric curves over epochs."""
        fig, ax = self._plt.subplots(figsize=(6.5, 4))
        for key, values in history.items():
            if len(values):
                ax.plot(values, label=key)
        ax.set_xlabel("epoch")
        ax.legend()
        ax.grid(alpha=0.3)
        return self._save(fig, name)

    def plot_similarity_matrix(self, sim: np.ndarray, name: str = "similarity") -> str:
        """Cosine-similarity heatmap."""
        fig, ax = self._plt.subplots(figsize=(5.5, 5))
        im = ax.imshow(_to_numpy(sim), cmap="coolwarm", vmin=-1, vmax=1)
        fig.colorbar(im, ax=ax)
        ax.set_title("cosine similarity")
        return self._save(fig, name)

    def plot_trajectory(self, trajectory: np.ndarray, name: str = "trajectory") -> str:
        """Latent trajectory and feature-evolution panels; a (steps, batch,
        dim) trajectory shows its first element."""
        traj = _to_numpy(trajectory)
        if traj.ndim == 3:
            traj = traj[:, 0]
        fig, axes = self._plt.subplots(1, 2, figsize=(10, 4))
        axes[0].plot(traj[:, 0], traj[:, 1], ".-")
        axes[0].set_title("Latent Space Trajectory")
        im = axes[1].imshow(traj.T, aspect="auto", cmap="viridis")
        axes[1].set_title("Feature Evolution")
        fig.colorbar(im, ax=axes[1])
        return self._save(fig, name)
