"""ESM-2-style protein transformer in PyTorch.

Counterpart of `clip_dplm_tpu/models/esm.py`: pre-LN blocks with rotary
q/k, exact-GELU FFN, a final LayerNorm, ESM's token-dropout rescaling,
mean-residue / cls pooling, and the soft token path (`token_probs`) that
soft CLIP guidance differentiates through. Parameters keep the flax names
(`embed_tokens`, `layer_<i>/{ln_attn,q,k,v,out,ln_ffn,ffn_in,ffn_out}`,
`final_ln`), so `utils/convert.py` maps a flax tree onto the `state_dict`.
The trunk is always unrolled; a stacked (`scan_layers`) flax tree is
unstacked on conversion.

Attention dispatch follows the reference by shape: the packed-qkv kernel with
in-kernel RoPE for 64 <= S < 256, the flash kernel for S >= 256, plain
attention below 64 (ops/attention.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_dplm_tpu_torch.config import ESMConfig
from clip_dplm_tpu_torch.models.layers import Dense, Embed, LayerNorm
from clip_dplm_tpu_torch.ops.attention import (
    attention_dispatch,
    merge_heads,
    packed_qkv_attention_proj,
    short_attn_packed_ok,
    split_heads,
)
from clip_dplm_tpu_torch.ops.short_attention import _rope_cos_sin, _rope_rot

# fraction of tokens masked during ESM-2 pretraining (0.15 * 0.8); used by
# the token-dropout rescaling at inference
_MASK_RATIO_TRAIN = 0.15 * 0.8

ESM2_SIZES = {
    "esm2_t6_8M": dict(num_layers=6, d_model=320, num_heads=20),
    "esm2_t12_35M": dict(num_layers=12, d_model=480, num_heads=20),
    "esm2_t30_150M": dict(num_layers=30, d_model=640, num_heads=20),
    "esm2_t33_650M": dict(num_layers=33, d_model=1280, num_heads=20),
    "esm2_t36_3B": dict(num_layers=36, d_model=2560, num_heads=40),
    "esm2_t48_15B": dict(num_layers=48, d_model=5120, num_heads=40),
}


def rotary_embed(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over the head dim of (B, H, S, Dh), ESM-2
    convention (rotate-half pairing), f32 math, cast back to x's dtype."""
    cos, sin = _rope_cos_sin(positions, x.shape[-1])
    return _rope_rot(x, cos, sin).to(x.dtype)


def rotary_embed_bsd(x: torch.Tensor, positions: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """rotary_embed in the head-major (B, S, D) layout, D = H * Dh."""
    B, S, D = x.shape
    Dh = D // num_heads
    cos, sin = _rope_cos_sin(positions, Dh)
    xh = x.reshape(B, S, num_heads, Dh)
    out = _rope_rot(xh, cos[:, None, :], sin[:, None, :])
    return out.reshape(B, S, D).to(x.dtype)


class EsmBlock(nn.Module):
    """Pre-LN transformer block with rotary q/k (ESM-2 layer semantics)."""

    def __init__(self, d_model: int, num_heads: int, ffn_mult: int = 4,
                 ln_eps: float = 1e-5, device=None):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        D, F_ = d_model, ffn_mult * d_model
        self.ln_attn = LayerNorm(D, ln_eps, device=device)
        self.q = Dense(D, D, device=device)
        self.k = Dense(D, D, device=device)
        self.v = Dense(D, D, device=device)
        self.out = Dense(D, D, device=device)
        self.ln_ffn = LayerNorm(D, ln_eps, device=device)
        self.ffn_in = Dense(D, F_, device=device)
        self.ffn_out = Dense(F_, D, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        """x (B, S, D) in the compute dtype; mask (B, S) bool."""
        dtype = x.dtype
        H, D = self.num_heads, self.d_model
        h = self.ln_attn(x).to(dtype)
        B, S, _ = h.shape
        if short_attn_packed_ok((B, S, 3 * D), H, mask):
            # one qkv matmul; RoPE, attention and the out-projection in the
            # packed kernel
            w_qkv = torch.cat([self.q.kernel, self.k.kernel, self.v.kernel], 0)
            b_qkv = torch.cat([self.q.bias, self.k.bias, self.v.bias])
            qkv = F.linear(h, w_qkv.to(dtype), b_qkv.to(dtype))
            attn = packed_qkv_attention_proj(
                qkv, self.out.kernel, self.out.bias, H, mask=mask,
                rope_positions=positions)
        else:
            qh = rotary_embed(split_heads(self.q(h), H), positions)
            kh = rotary_embed(split_heads(self.k(h), H), positions)
            vh = split_heads(self.v(h), H)
            attn = self.out(merge_heads(attention_dispatch(qh, kh, vh, mask=mask)))
        x = x + attn
        h = self.ln_ffn(x).to(dtype)
        h = self.ffn_out(F.gelu(self.ffn_in(h)))
        return x + h


def stack_esm_layers(params: Dict, num_layers: int) -> Dict:
    """Unrolled flax tree (layer_<i>/...) -> the scan_layers layout
    (layers/block/... stacked on axis 0), over nested dicts of arrays."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([np.asarray(t) for t in trees])

    rest = {k: v for k, v in params.items() if not k.startswith("layer_")}
    rest["layers"] = {"block": stack([params[f"layer_{i}"]
                                      for i in range(num_layers)])}
    return rest


def unstack_esm_layers(params: Dict, num_layers: int) -> Dict:
    """Inverse of `stack_esm_layers`."""
    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    stacked = params["layers"]["block"]
    rest = {k: v for k, v in params.items() if k != "layers"}
    for i in range(num_layers):
        rest[f"layer_{i}"] = take(stacked, i)
    return rest


class ESMTower(nn.Module):
    """ESM-2 encoder over token ids (B, S) with a (B, S) validity mask.

    Token ids follow the ESM alphabet (data/protein.py): 0=<cls>, 1=<pad>,
    2=<eos>, 32=<mask>. `dtype` is the compute dtype of the trunk."""

    MASK_IDX = 32
    CLS_IDX = 0
    EOS_IDX = 2
    PAD_IDX = 1

    def __init__(self, cfg: ESMConfig, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.embed_tokens = Embed(cfg.vocab_size, cfg.d_model, device=device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EsmBlock(
                cfg.d_model, cfg.num_heads, ln_eps=cfg.layer_norm_eps,
                device=device))
        self.final_ln = LayerNorm(cfg.d_model, cfg.layer_norm_eps, device=device)

    @property
    def blocks(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.embedding.device

    def embed(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
              token_probs: Optional[torch.Tensor] = None):
        """Token embedding (hard, or soft from `token_probs`), token-dropout
        rescaling and pad zeroing. Returns (h, mask, positions)."""
        c = self.cfg
        B, S = tokens.shape
        if mask is None:
            mask = tokens != self.PAD_IDX
        table = self.embed_tokens.embedding
        if token_probs is None:
            emb = self.embed_tokens(tokens).float()
        else:
            emb = token_probs.float() @ table.float()
        if c.token_dropout:
            if token_probs is None:
                p_mask = (tokens == self.MASK_IDX).float()
                emb = torch.where((tokens == self.MASK_IDX)[..., None], 0.0, emb)
            else:
                # the expected <mask> row taken out: zeroing in the one-hot
                # limit, smooth in between
                p_mask = token_probs[..., self.MASK_IDX].float()
                emb = emb - p_mask[..., None] * table[self.MASK_IDX].float()
            n_real = mask.sum(dim=-1, keepdim=True).clamp(min=1)
            ratio = (p_mask * mask).sum(dim=-1, keepdim=True) / n_real
            scale = (1.0 - _MASK_RATIO_TRAIN) / (1.0 - ratio).clamp(min=1e-6)
            emb = emb * scale[..., None]
        emb = torch.where(mask[..., None], emb, 0.0)
        positions = torch.arange(S, device=tokens.device)
        return emb.to(self.dtype), mask, positions

    def head(self, h: torch.Tensor, tokens: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             pooling: str = "tokens") -> torch.Tensor:
        """Final LayerNorm (f32) + pooling."""
        if mask is None:
            mask = tokens != self.PAD_IDX
        h = self.final_ln(h)
        if pooling == "tokens":
            return h
        if pooling == "mean_residues":
            residue = mask & (tokens != self.CLS_IDX) & (tokens != self.EOS_IDX)
            w = residue[..., None].to(h.dtype)
            return (h * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
        if pooling == "cls":
            return h[:, 0]
        raise ValueError(f"unknown pooling {pooling!r}")

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                pooling: str = "tokens",
                token_probs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`token_probs` (B, S, vocab): soft token distributions; the lookup
        becomes probs @ table, differentiable in probs (the relaxation behind
        soft CLIP guidance of the DPLM sampler), equal to the hard path at
        one-hot(tokens). `tokens` still gives the special-token positions for
        the mask and the pooling."""
        h, mask, positions = self.embed(tokens, mask, token_probs)
        for block in self.blocks:
            h = block(h, mask, positions)
        return self.head(h, tokens, mask, pooling)


def esm_config_from_name(name: str, **overrides) -> ESMConfig:
    geom = ESM2_SIZES[name]
    return ESMConfig(name=name, **{**geom, **overrides})
