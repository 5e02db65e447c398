"""Contrastive loss variants beyond plain InfoNCE, in plain PyTorch.

Counterpart of `clip_dplm_tpu/ops/loss_variants.py`, which computes them in
XLA with no Pallas kernel:

  * `supcon_loss` — supervised contrastive (Khosla et al. 2020) over one
    embedding space: all same-class samples are positives, averaged in
    log-space per anchor.
  * `supcon_pair_loss` — its cross-modal form: the positives of a row are
    all columns of the other modality that share its class label.
  * `flatnce_loss` — FlatNCE (arXiv:2107.01152): the surrogate
    z / detach(z), z = Σ_{j≠i} exp(s_ij − s_ii), whose value is 1 and whose
    gradient is FlatNCE's; `infonce_monitor` is softplus(log z), the InfoNCE
    value.
  * `siglip_loss` — pairwise sigmoid contrastive: mean softplus(−z_ij·s_ij)
    with z = +1 on the diagonal and −1 off it, an optional logit bias.

Everything is f32 (f64 for f64 inputs), on the port's `l2_normalize`,
`effective_scale` and `similarity_logits` (ops/infonce.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from clip_dplm_tpu_torch.ops.infonce import (
    NEG_INF,
    effective_scale,
    l2_normalize,
    similarity_logits,
)


def supcon_loss(emb: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.1) -> torch.Tensor:
    """Supervised contrastive loss over one embedding space:
    L = −mean_i 1/|P(i)| Σ_{p∈P(i)} log(exp(s_ip/t) / Σ_{a≠i} exp(s_ia/t)),
    anchors with no positive left out of the mean."""
    z = l2_normalize(emb)
    sim = (z @ z.t()) / temperature
    n = sim.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=sim.device)
    same = (labels[:, None] == labels[None, :]) & ~eye
    sim = torch.where(eye, NEG_INF, sim)
    log_prob = sim - torch.logsumexp(sim, dim=1, keepdim=True)
    pos_count = same.sum(dim=1).clamp(min=1)
    per_anchor = torch.where(same, log_prob, 0.0).sum(dim=1) / pos_count
    has_pos = same.any(dim=1)
    return -(torch.where(has_pos, per_anchor, 0.0).sum() / has_pos.sum().clamp(min=1))


def supcon_pair_loss(emb_a: torch.Tensor, emb_b: torch.Tensor, labels: torch.Tensor,
                     logit_scale: torch.Tensor, max_scale: float = 100.0,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-modal supervised contrastive: the mean of the two directions'
    losses, each row's log-probabilities averaged over the columns that
    share its label."""
    a, b = l2_normalize(emb_a), l2_normalize(emb_b)
    scale = effective_scale(logit_scale, max_scale)
    sim = similarity_logits(a, b, scale)
    same = labels[:, None] == labels[None, :]
    pos_count = same.sum(dim=1).clamp(min=1)

    def directional(s):
        log_prob = s - torch.logsumexp(s, dim=1, keepdim=True)
        return -(torch.where(same, log_prob, 0.0).sum(dim=1) / pos_count).mean()

    loss = 0.5 * (directional(sim) + directional(sim.t()))
    return loss, {"logit_scale": scale}


def flatnce_loss(emb_a: torch.Tensor, emb_b: torch.Tensor, logit_scale: torch.Tensor,
                 max_scale: float = 100.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric FlatNCE: the mean over both directions of z / detach(z)
    (value 1, FlatNCE's gradient), with the InfoNCE value softplus(log z)
    as `infonce_monitor`."""
    a, b = l2_normalize(emb_a), l2_normalize(emb_b)
    scale = effective_scale(logit_scale, max_scale)
    sim = similarity_logits(a, b, scale)
    eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)

    def directional(s):
        pos = torch.diagonal(s)[:, None]
        neg = torch.where(eye, NEG_INF, s)
        lse = torch.logsumexp(neg - pos, dim=1)
        z = torch.exp(lse)
        surrogate = z / z.detach().clamp(min=1e-30)
        return surrogate.mean(), F.softplus(lse).mean()

    sa, ma = directional(sim)
    sb, mb = directional(sim.t())
    return 0.5 * (sa + sb), {"infonce_monitor": 0.5 * (ma + mb), "logit_scale": scale}


def siglip_loss(emb_a: torch.Tensor, emb_b: torch.Tensor, logit_scale: torch.Tensor,
                logit_bias: Optional[torch.Tensor] = None, max_scale: float = 100.0,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pairwise sigmoid loss: mean_ij softplus(−z_ij·(scale·s_ij + bias)),
    z = +1 on the diagonal and −1 off it; `accuracy` is the a→b top-1."""
    a, b = l2_normalize(emb_a), l2_normalize(emb_b)
    scale = effective_scale(logit_scale, max_scale)
    sim = similarity_logits(a, b, scale)
    if logit_bias is not None:
        sim = sim + logit_bias
    n = sim.shape[0]
    z = 2.0 * torch.eye(n, dtype=sim.dtype, device=sim.device) - 1.0
    loss = F.softplus(-z * sim).mean()
    acc = (sim.argmax(dim=1) == torch.arange(n, device=sim.device)).to(sim.dtype).mean()
    return loss, {"accuracy": acc, "logit_scale": scale}
