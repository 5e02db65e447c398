"""Memory telemetry and input-data validation.

Counterpart of `clip_dplm_tpu/utils/system.py`: `get_memory_status` reads
each card's CUDA allocator (`torch.cuda.memory_stats`) and its free and
total memory (`torch.cuda.mem_get_info`) under the JAX package's key names;
`validate_data` and `DataValidationError` are copied.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def get_memory_status() -> Dict[str, float]:
    """Per-card memory in GiB: `device<i>_bytes_in_use_gib` (the allocator's
    allocated bytes), `device<i>_peak_bytes_gib` (their peak),
    `device<i>_limit_gib` (the card's total memory) and
    `device<i>_utilization` (in use over the total). Empty without a
    card."""
    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    gib = 1024 ** 3
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        in_use = stats.get("allocated_bytes.all.current", 0)
        out[f"device{i}_bytes_in_use_gib"] = in_use / gib
        out[f"device{i}_peak_bytes_gib"] = stats.get("allocated_bytes.all.peak", in_use) / gib
        _, total = torch.cuda.mem_get_info(i)
        if total:
            out[f"device{i}_limit_gib"] = total / gib
            out[f"device{i}_utilization"] = in_use / total
    return out


class DataValidationError(ValueError):
    pass


def validate_data(
    x: np.ndarray,
    name: str = "data",
    max_missing_fraction: float = 0.0,
    min_value: Optional[float] = None,
    max_value: Optional[float] = None,
    min_variance: float = 0.0,
) -> Dict[str, float]:
    """Input QC: NaN/Inf fraction, value range, degenerate (zero-variance)
    features. Raises DataValidationError on violation; returns the computed
    stats."""
    x = np.asarray(x)
    finite = np.isfinite(x)
    missing = 1.0 - finite.mean()
    stats = {
        "missing_fraction": float(missing),
        "min": float(x[finite].min()) if finite.any() else float("nan"),
        "max": float(x[finite].max()) if finite.any() else float("nan"),
        "mean_variance": float(np.nanvar(np.where(finite, x, np.nan), axis=0).mean())
        if x.ndim == 2 else float(np.nanvar(x)),
    }
    if missing > max_missing_fraction:
        raise DataValidationError(
            f"{name}: {missing:.2%} non-finite values "
            f"(allowed {max_missing_fraction:.2%})"
        )
    if min_value is not None and stats["min"] < min_value:
        raise DataValidationError(f"{name}: min {stats['min']} < {min_value}")
    if max_value is not None and stats["max"] > max_value:
        raise DataValidationError(f"{name}: max {stats['max']} > {max_value}")
    if x.ndim == 2 and min_variance > 0:
        dead = (np.var(x, axis=0) < min_variance).sum()
        stats["dead_features"] = float(dead)
        if dead == x.shape[1]:
            raise DataValidationError(f"{name}: all features below variance floor")
    return stats
