"""Symmetric InfoNCE / CLIP loss in plain PyTorch: the unfused loss and the
target the fused kernel (ops/fused_infonce.py) is held to.

Counterpart of `clip_dplm_tpu/ops/infonce.py` (`l2_normalize`,
`similarity_logits`, `effective_scale`, `_cross_entropy`, `clip_loss`,
`multiway_clip_loss`) without the hard-negative cache and the mesh gather, which the port does not
have yet. Everything is f32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

NEG_INF = -1e30


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics over the last dim, computed in f32."""
    x = x.float()
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def similarity_logits(a: torch.Tensor, b: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """scale * a @ b.T in f32 (the B x B matmul)."""
    return scale * (a.float() @ b.float().t())


def effective_scale(logit_scale: torch.Tensor,
                    max_scale: float = 100.0) -> torch.Tensor:
    """exp(logit_scale) clamped at max_scale; the gradient is zero above the
    clamp, as jnp.minimum's is."""
    return torch.clamp(torch.exp(logit_scale.float()), max=max_scale)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-row CE in f32. Label smoothing puts 1 - s on the target and
    s / (n - 1) on each other VALID column (columns at -1e30 are excluded
    from the count and the sum), which is not F.cross_entropy's smoothing."""
    logits = logits.float()
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
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-device symmetric InfoNCE over the materialized B x B
    similarity. Returns (loss, metrics)."""
    if normalize:
        emb_a, emb_b = l2_normalize(emb_a), l2_normalize(emb_b)
    scale = effective_scale(logit_scale, max_scale)
    sim = similarity_logits(emb_a, emb_b, scale)
    labels = torch.arange(sim.shape[0], device=sim.device)
    loss_a = _cross_entropy(sim, labels, label_smoothing).mean()
    loss_b = _cross_entropy(sim.t(), labels, label_smoothing).mean()
    acc_a = (sim.argmax(dim=-1) == labels).float().mean()
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
                       max_scale: float = 100.0, label_smoothing: float = 0.0,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum of the symmetric InfoNCE of every pair of modalities (the 3-way
    TF loss: cell<->pert + cell<->protein + pert<->protein). Metrics: each
    pair's loss and accuracy."""
    total = torch.zeros((), device=logit_scale.device)
    metrics: Dict[str, torch.Tensor] = {}
    for a, b in modality_pairs(embeddings):
        loss, m = clip_loss(embeddings[a], embeddings[b], logit_scale,
                            label_smoothing=label_smoothing, max_scale=max_scale)
        total = total + loss
        metrics[f"loss_{a}_{b}"] = loss
        metrics[f"accuracy_{a}_{b}"] = m["accuracy"]
    return total, metrics
