"""Symmetric InfoNCE / CLIP loss in plain PyTorch: the unfused loss and the
target the fused kernel (ops/fused_infonce.py) is held to.

Counterpart of `clip_dplm_tpu/ops/infonce.py` (`l2_normalize`,
`similarity_logits`, `effective_scale`, `_cross_entropy`, `clip_loss` with
its hard-negative cache columns, `multiway_clip_loss`, `update_cache`)
without the mesh gather, which the port does not have yet. Everything is
f32 (f64 for f64 inputs, as the f64 reference runs of the f32 families
take it).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in its own dtype where that is wider (the f64 reference
    runs of the f32 families): the compute dtype of every f32 op of the
    port."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics over the last dim, computed in f32."""
    x = at_least_f32(x)
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def similarity_logits(a: torch.Tensor, b: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """scale * a @ b.T in f32 (the B x B matmul)."""
    return scale * (at_least_f32(a) @ at_least_f32(b).t())


def effective_scale(logit_scale: torch.Tensor,
                    max_scale: float = 100.0) -> torch.Tensor:
    """exp(logit_scale) clamped at max_scale; the gradient is zero above the
    clamp, as jnp.minimum's is."""
    return torch.clamp(torch.exp(at_least_f32(logit_scale)), max=max_scale)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-row CE in f32. Label smoothing puts 1 - s on the target and
    s / (n - 1) on each other VALID column (columns at -1e30 are excluded
    from the count and the sum), which is not F.cross_entropy's smoothing."""
    logits = at_least_f32(logits)
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, 1, labels[:, None])[:, 0]
    if label_smoothing > 0.0:
        valid = logits > 0.5 * NEG_INF
        n = valid.sum(dim=-1).float()
        smooth = label_smoothing / torch.clamp(n - 1.0, min=1.0)
        row_sum = torch.where(valid, logits, 0.0).sum(dim=-1)
        weighted = ((1.0 - label_smoothing) * label_logit
                    + smooth * (row_sum - label_logit))
        return logz - weighted
    return logz - label_logit


def clip_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
              logit_scale: torch.Tensor, label_smoothing: float = 0.0,
              max_scale: float = 100.0, normalize: bool = True,
              cache: Optional[torch.Tensor] = None,
              cache_len: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-device symmetric InfoNCE over the materialized B x B
    similarity. `cache` (C, d) holds hard-negative embeddings appended as
    extra columns to the a->b direction only; columns at or past `cache_len`
    (the unfilled tail of the ring) are masked with -1e30. Accuracy is taken
    over the widened logits. Returns (loss, metrics)."""
    if normalize:
        emb_a, emb_b = l2_normalize(emb_a), l2_normalize(emb_b)
    scale = effective_scale(logit_scale, max_scale)
    sim = similarity_logits(emb_a, emb_b, scale)
    labels = torch.arange(sim.shape[0], device=sim.device)
    logits_a = sim
    if cache is not None:
        sim_cache = similarity_logits(emb_a, cache, scale)
        if cache_len is not None:
            col = torch.arange(cache.shape[0], device=sim.device)[None, :]
            sim_cache = torch.where(col < cache_len, sim_cache, NEG_INF)
        logits_a = torch.cat([sim, sim_cache], dim=1)
    loss_a = _cross_entropy(logits_a, labels, label_smoothing).mean()
    loss_b = _cross_entropy(sim.t(), labels, label_smoothing).mean()
    acc_a = (logits_a.argmax(dim=-1) == labels).float().mean()
    acc_b = (sim.t().argmax(dim=-1) == labels).float().mean()
    metrics = {"loss_a": loss_a, "loss_b": loss_b, "accuracy_a": acc_a,
               "accuracy_b": acc_b, "accuracy": 0.5 * (acc_a + acc_b),
               "logit_scale": scale}
    return 0.5 * (loss_a + loss_b), metrics


def modality_pairs(names):
    """Every unordered pair of the names, in order: (0, 1), (0, 2), (1, 2)..."""
    names = list(names)
    return [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]


def multiway_clip_loss(embeddings: Dict[str, torch.Tensor], logit_scale: torch.Tensor,
                       pairs: Optional[Sequence[Tuple[str, str]]] = None,
                       max_scale: float = 100.0, label_smoothing: float = 0.0,
                       weights: Optional[Dict[Tuple[str, str], float]] = None,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the symmetric InfoNCE of modality pairs (the 3-way
    TF loss: cell<->pert + cell<->protein + pert<->protein). `pairs`
    defaults to every unordered pair of the embeddings, in order; a pair
    naming a modality that is missing is skipped, as the reference skips
    it; `weights.get((a, b), 1.0)` scales pair (a, b) in the total. Metrics:
    each pair's (unweighted) loss and accuracy."""
    total = torch.zeros((), device=logit_scale.device)
    metrics: Dict[str, torch.Tensor] = {}
    for a, b in modality_pairs(embeddings) if pairs is None else pairs:
        if a not in embeddings or b not in embeddings:
            continue
        loss, m = clip_loss(embeddings[a], embeddings[b], logit_scale,
                            label_smoothing=label_smoothing, max_scale=max_scale)
        total = total + (1.0 if weights is None else weights.get((a, b), 1.0)) * loss
        metrics[f"loss_{a}_{b}"] = loss
        metrics[f"accuracy_{a}_{b}"] = m["accuracy"]
    return total, metrics


def update_cache(cache: torch.Tensor, ptr: torch.Tensor, new: torch.Tensor,
                 filled: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The circular hard-negative cache (old/clip_opt.py:76-81 semantics):
    if ptr + B would overflow the C rows, ptr resets to 0 first; then the B
    rows of `new` are written at ptr and ptr advances modulo C. Returns
    (cache, ptr, filled); `filled` is a high-water mark, so a warm cache keeps
    its negatives across a wrap. `ptr` and `filled` are int32 device scalars
    and the write is an in-place `index_copy_` into `cache` (the reference's
    is a functional update): nothing waits on the device."""
    C, B = cache.shape[0], new.shape[0]
    if B > C:
        raise ValueError(f"a batch of {B} rows does not fit a cache of {C} rows")
    if filled is None:
        filled = ptr
    ptr = torch.where(ptr + B > C, torch.zeros_like(ptr), ptr)
    rows = ptr.long() + torch.arange(B, device=cache.device)
    cache.index_copy_(0, rows, new.detach().to(cache.dtype))
    end = ptr + B
    return cache, end % C, torch.maximum(filled, end)
