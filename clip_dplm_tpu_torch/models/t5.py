"""ProtT5 encoder (the T5 v1.0 encoder stack) in PyTorch.

Counterpart of `clip_dplm_tpu/models/t5.py`, the protein language model of
Rostlab/prot_t5_xl_half_uniref50-enc:

- `T5LayerNorm` is RMS norm with a scale and no bias, computed in f32;
- one bucketed, bidirectional relative position bias (`relative_position_
  bucket`), owned at the top (HF: by block 0) and shared by every layer;
- attention scores are NOT scaled by 1/sqrt(d_kv); padded keys take a -1e9
  bias; the softmax is f32;
- a ReLU FFN, and no bias in any projection;
- `mean_residues` pooling averages over the residues, `</s>` left out.

Parameters keep the flax names (`embed_tokens`, `relative_attention_bias`,
`layer_<i>/{ln_attn,attn/{q,k,v,o},ln_ffn,wi,wo}`, `final_ln`), so
utils/convert.py maps a flax tree onto the state_dict. The JAX package
computes this attention in XLA, outside any Pallas kernel (the additive
relative bias keeps it off the flash kernel), so it is plain PyTorch here on
every device. `convert_t5_torch_params` / `export_t5_torch_params` map an HF
`T5EncoderModel` state_dict onto the port's and back.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_dplm_tpu_torch.config import ProtT5Config
from clip_dplm_tpu_torch.models.layers import Dense, Embed, numpy_f32, remat_call

NEG_INF = -1e9


class T5LayerNorm(nn.Module):
    """RMS norm with a scale only (HF T5LayerNorm): x / rms(x) * w, f32."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))

    def reset_own_params(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return x32 * torch.rsqrt(var + self.eps) * self.weight


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """The bidirectional T5 bucket of each relative position: half the
    buckets for each sign, the near half exact, the far half log-spaced up
    to max_distance. int64."""
    num_buckets //= 2
    ret = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact + 1e-9)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def _dense(in_features: int, features: int, device) -> Dense:
    return Dense(in_features, features, device=device, use_bias=False)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: ProtT5Config, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q, self.k, self.v = (_dense(cfg.d_model, inner, device) for _ in range(3))
        self.o = _dense(inner, cfg.d_model, device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """`bias` (B, H, S, S) f32: the shared relative bias plus the key
        mask's -1e9 (adding the two first changes no unmasked score)."""
        c = self.cfg
        B, S, _ = x.shape

        def heads(t):
            return t.reshape(B, S, c.num_heads, c.d_kv).transpose(1, 2)

        qh, kh, vh = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        # unscaled scores in f32
        logits = qh.float() @ kh.float().transpose(-1, -2) + bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        attn = (probs.float() @ vh.float()).to(x.dtype)
        return self.o(attn.transpose(1, 2).reshape(B, S, c.num_heads * c.d_kv))


class T5Block(nn.Module):
    def __init__(self, cfg: ProtT5Config, device=None):
        super().__init__()
        self.ln_attn = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, device)
        self.attn = T5SelfAttention(cfg, device)
        self.ln_ffn = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, device)
        self.wi = _dense(cfg.d_model, cfg.d_ff, device)
        self.wo = _dense(cfg.d_ff, cfg.d_model, device)

    def forward(self, x, bias):
        dtype = x.dtype
        x = x + self.attn(self.ln_attn(x).to(dtype), bias)
        h = self.wo(F.relu(self.wi(self.ln_ffn(x).to(dtype))))
        return x + h


class ProtT5Tower(nn.Module):
    """T5 encoder over ProtT5 token ids (B, S) with a (B, S) validity mask.
    Ids follow the ProtTrans vocabulary (data/protein.py::tokenize_prot_t5):
    0=<pad>, 1=</s>, 2=<unk>, 3..=residues. `dtype` is the compute dtype;
    the norms and the output are f32."""

    PAD_IDX = 0
    EOS_IDX = 1

    def __init__(self, cfg: ProtT5Config, dtype: torch.dtype = torch.bfloat16, device=None,
                 remat: bool = False):
        super().__init__()
        self.cfg, self.dtype, self.remat = cfg, dtype, remat
        self.embed_tokens = Embed(cfg.vocab_size, cfg.d_model, device=device)
        self.relative_attention_bias = nn.Parameter(torch.empty(
            cfg.relative_attention_num_buckets, cfg.num_heads, dtype=torch.float32,
            device=device))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", T5Block(cfg, device))
        self.final_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, device)

    def reset_own_params(self, generator: torch.Generator) -> None:
        """The relative bias: normal with std 1/sqrt(d_model), as the flax
        module's initializer."""
        with torch.no_grad():
            self.relative_attention_bias.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model),
                                                 generator=generator)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.embedding.device

    def position_bias(self, S: int) -> torch.Tensor:
        """(1, H, S, S) f32: the shared relative bias of every (query, key)."""
        c = self.cfg
        pos = torch.arange(S, device=self.device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], num_buckets=c.relative_attention_num_buckets,
            max_distance=c.relative_attention_max_distance)
        return self.relative_attention_bias[buckets].permute(2, 0, 1)[None].float()

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                pooling: str = "tokens") -> torch.Tensor:
        if mask is None:
            mask = tokens != self.PAD_IDX
        emb = self.embed_tokens(tokens).float()
        h = torch.where(mask[..., None], emb, 0.0).to(self.dtype)
        # one (B, H, S, S) bias for every layer: relative positions + key mask
        bias = self.position_bias(tokens.shape[1]) + torch.where(
            mask[:, None, None, :], 0.0, NEG_INF)
        for i in range(self.cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                h = remat_call(block, h, bias)
            else:
                h = block(h, bias)
        h = self.final_ln(h)
        if pooling == "tokens":
            return h
        if pooling == "mean_residues":
            w = (mask & (tokens != self.EOS_IDX))[..., None].to(h.dtype)
            return (h * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
        raise ValueError(f"unknown pooling {pooling!r}")


def prot_t5_config_from_name(name: str, **overrides) -> ProtT5Config:
    """The published ProtTrans encoder geometries."""
    presets = {
        # Rostlab/prot_t5_xl_* (t5-3b geometry, encoder half)
        "prot_t5_xl": dict(d_model=1024, d_ff=16384, num_layers=24, num_heads=32, d_kv=128),
        # Rostlab/prot_t5_base_mt_uniref50
        "prot_t5_base": dict(d_model=768, d_ff=3072, num_layers=12, num_heads=12, d_kv=64),
    }
    if name not in presets:
        raise ValueError(f"unknown ProtT5 preset {name!r}")
    return ProtT5Config(**{**presets[name], **overrides})


def _t5_hf_names(cfg: ProtT5Config) -> Dict[str, str]:
    """The port's ProtT5Tower state_dict names -> HF `T5EncoderModel`
    names."""
    names = {"embed_tokens.embedding": "shared.weight",
             "relative_attention_bias":
                 "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
             "final_ln.weight": "encoder.final_layer_norm.weight"}
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        names[f"layer_{i}.ln_attn.weight"] = f"{pre}.0.layer_norm.weight"
        for p in ("q", "k", "v", "o"):
            names[f"layer_{i}.attn.{p}.kernel"] = f"{pre}.0.SelfAttention.{p}.weight"
        names[f"layer_{i}.ln_ffn.weight"] = f"{pre}.1.layer_norm.weight"
        for p in ("wi", "wo"):
            names[f"layer_{i}.{p}.kernel"] = f"{pre}.1.DenseReluDense.{p}.weight"
    return names



def convert_t5_torch_params(state_dict, cfg: ProtT5Config) -> Dict[str, torch.Tensor]:
    """HF `T5EncoderModel.state_dict()` (torch tensors or numpy arrays) ->
    the port's ProtT5Tower state_dict, f32 on the CPU (torch's Linear
    weight is the port's (out, in) kernel: nothing is transposed)."""
    return {k: torch.from_numpy(numpy_f32(state_dict[v])) for k, v in _t5_hf_names(cfg).items()}


def export_t5_torch_params(params, cfg: ProtT5Config) -> Dict[str, np.ndarray]:
    """Inverse of `convert_t5_torch_params`: a ProtT5Tower (or its
    state_dict) -> an HF `T5EncoderModel` state_dict, numpy f32, the shared
    embedding also under `encoder.embed_tokens.weight`, equal to the JAX
    package's `export_t5_torch_params` of the same weights."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    out = {hf: numpy_f32(sd[name]) for name, hf in _t5_hf_names(cfg).items()}
    out["encoder.embed_tokens.weight"] = out["shared.weight"].copy()
    return out
