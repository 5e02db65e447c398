"""Segment reductions over padded graph batches.

Counterpart of `clip_dplm_tpu/ops/segment.py`: `segment_sum`,
`segment_mean` and `segment_softmax` with validity masks, so that padded
nodes and edges (padded edges point at node 0) contribute nothing. Every
index must lie in [0, num_segments).

The sums are `index_add`, the maximum `scatter_reduce("amax",
include_self=False)` on a base of -inf (an empty segment's maximum, as
`jax.ops.segment_max` gives it). On the card `index_add` adds with atomics
in no fixed order, so two runs of a step can differ in the last bits: the
port accepts run-to-run differences here, and the smoke's repeat checks on
this family are relative, never bitwise.
"""

from __future__ import annotations

from typing import Optional

import torch


def _masked(data: torch.Tensor, mask: Optional[torch.Tensor], fill: float) -> torch.Tensor:
    if mask is None:
        return data
    m = mask[..., None] if data.ndim > mask.ndim else mask
    return torch.where(m, data, fill)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_segments, ...) sums of the rows of `data` by segment; rows with
    mask False add zero."""
    data = _masked(data, mask, 0.0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scatter_mean over the valid rows of (rows, d) `data`; an empty
    segment's mean is 0."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    ones = (torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
            if mask is None else mask.to(data.dtype))
    counts = ones.new_zeros(num_segments).index_add(0, segment_ids.long(), ones)
    return total / torch.clamp(counts[:, None], min=1.0)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(num_segments, ...) maxima; -inf for an empty segment."""
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    base = data.new_full((num_segments,) + tuple(data.shape[1:]), float("-inf"))
    return base.scatter_reduce(0, idx, data, "amax", include_self=False)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of the scores within each segment (per-node edge attention);
    masked rows get 0 and take no part."""
    scores = _masked(scores, mask, -1e30)
    seg_max = segment_max(scores, segment_ids, num_segments)
    exp = torch.exp(scores - seg_max[segment_ids.long()])
    exp = _masked(exp, mask, 0.0)
    denom = segment_sum(exp, segment_ids, num_segments)
    return exp / torch.clamp(denom[segment_ids.long()], min=1e-30)
