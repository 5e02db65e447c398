"""CLIP-guided protein generation (BASELINE.json config 5).

Counterpart of `clip_dplm_tpu/models/guided_generation.py`. A trained
contrastive model gives the score s(x) = cos(f_protein(x), c) of a generated
protein against a conditioning embedding c (from the other tower), and the
DPLM sampler is steered by it:

  * hard guidance: best-of-K reranking (models/dplm.py::clip_guided_sample);
  * soft guidance: a logit bias at every sampler step, the exact gradient of
    the relaxed score with respect to the sampler's logits
    (`make_soft_logit_bias_fn`): still-masked positions enter the protein
    tower as their softmax distribution through ESMTower's `token_probs`
    path, decided ones as their one-hot.

The scorers take token ids (and soft distributions) with any leading axes
before (B, S): the best-of-K sampler hands them all K candidates at once (the
reference vmaps over the K views), and a (B, d) condition broadcasts over
them. An encode function maps (rows, S) tokens and mask (and, for the soft
scorer, (rows, S, vocab) probabilities) to (rows, d) embeddings, e.g.
`ESMProteinCLIP.encode_protein`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from clip_dplm_tpu_torch.models.dplm import DPLM, MASK_IDX, PAD_IDX, clip_guided_sample
from clip_dplm_tpu_torch.ops.infonce import l2_normalize


def _condition(condition_embedding) -> torch.Tensor:
    """(B, d) or (d,) array-like -> (rows, d) L2-normalized f32."""
    return l2_normalize(torch.atleast_2d(torch.as_tensor(condition_embedding)))


def _cosine(emb: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """Cosine of (..., B, d) embeddings (normalized here) with one condition
    or one a row."""
    emb, cond = l2_normalize(emb), cond.to(emb.device)
    if cond.shape[0] == 1:
        return emb @ cond[0]
    return (emb * cond).sum(dim=-1)


def make_clip_scorer(
    protein_encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    condition_embedding,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """score_fn(tokens (..., B, S)) -> (..., B): the cosine of
    protein_encode_fn(tokens, tokens != <pad>) with the condition, (B, d) or
    (d,). All rows go through the encoder in one call."""
    cond = _condition(condition_embedding)

    def score_fn(tokens: torch.Tensor) -> torch.Tensor:
        flat = tokens.reshape(-1, tokens.shape[-1])
        emb = protein_encode_fn(flat, flat != PAD_IDX)
        return _cosine(emb.reshape(*tokens.shape[:-1], -1), cond)

    return score_fn


def make_soft_logit_bias_fn(
    soft_score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    guidance_scale: float = 1.0,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """logit_bias_fn(tokens, logits) = guidance_scale * d score / d logits,
    the score `soft_score_fn(x, tokens)` summed over rows, where x holds
    softmax(logits) at still-masked positions and the one-hot of the token
    elsewhere: one exact gradient-ascent step on the relaxed objective per
    denoising step. The gradient is taken with autograd enabled, inside the
    sampler's no-grad loop (torch.autograd.grad with respect to the logits
    alone)."""

    def logit_bias_fn(tokens: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        onehot = F.one_hot(tokens.long(), logits.shape[-1]).float()
        undecided = (tokens == MASK_IDX)[..., None]
        with torch.enable_grad():
            lg = logits.detach().float().requires_grad_(True)
            x = torch.where(undecided, torch.softmax(lg, dim=-1), onehot)
            (g,) = torch.autograd.grad(soft_score_fn(x, tokens).sum(), lg)
        return guidance_scale * g

    return logit_bias_fn


def make_soft_clip_scorer(
    soft_encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    condition_embedding,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """soft_score_fn(probs (..., B, S, V), tokens (..., B, S)) -> (..., B):
    the cosine of soft_encode_fn(probs, tokens) (rows, d) with the
    condition, the relaxed score for make_soft_logit_bias_fn."""
    cond = _condition(condition_embedding)

    def soft_score_fn(probs: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        S, V = probs.shape[-2:]
        emb = soft_encode_fn(probs.reshape(-1, S, V), tokens.reshape(-1, S))
        return _cosine(emb.reshape(*tokens.shape[:-1], -1), cond)

    return soft_score_fn


def generate_proteins_for_condition(
    dplm: DPLM,
    protein_encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    condition_embedding,
    generator: torch.Generator,
    length: int,
    batch_size: int = 1,
    num_candidates: Optional[int] = None,
    num_steps: Optional[int] = None,
    temperature: float = 1.0,
    soft_encode_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    guidance_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample K candidate chains from the DPLM, score each with the CLIP
    protein tower and keep the best per row; with `soft_encode_fn` every
    chain is also steered per step by the relaxed score's gradient (soft
    guidance composes with reranking). `generator` lives on the DPLM's
    device. Returns (tokens (B, length+2), clip scores (B,))."""
    logit_bias_fn = None
    if soft_encode_fn is not None:
        logit_bias_fn = make_soft_logit_bias_fn(
            make_soft_clip_scorer(soft_encode_fn, condition_embedding),
            guidance_scale=guidance_scale)
    return clip_guided_sample(
        dplm, generator, make_clip_scorer(protein_encode_fn, condition_embedding),
        batch_size=batch_size, length=length, num_candidates=num_candidates,
        num_steps=num_steps, temperature=temperature, logit_bias_fn=logit_bias_fn)
