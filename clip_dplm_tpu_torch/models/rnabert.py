"""RNABERT-compatible RNA base encoder in PyTorch.

Counterpart of `clip_dplm_tpu/models/rnabert.py`: a post-LN BERT stack at
the published RNABERT geometry (hidden 120, 6 layers, 12 heads: the 120-wide
per-base embeddings the RNA towers consume), with its base tokenizer and a
converter for HF `BertModel` state_dicts. What it keeps of the reference:

- post-LN blocks (LayerNorm after each residual add), eps 1e-12, f32 norms;
- exact (erf) GELU in the FFN;
- attention scores scaled by 1/sqrt(d_head), padded keys at -1e9, f32
  softmax;
- the embeddings' padding rows zeroed before the first layer;
- DNA's T read as U by the tokenizer, and no special tokens.

Parameters keep the flax names (`word_embeddings`, `position_embeddings`,
`token_type_embeddings`, `embed_ln`, `layer_<i>/{q,k,v,attn_out,ln_attn,
ffn_in,ffn_out,ln_ffn}`), so utils/convert.py maps a flax tree onto the
state_dict. The JAX package computes this attention in XLA, outside any
Pallas kernel; here it is plain PyTorch on every device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_dplm_tpu_torch.config import RNABertConfig
from clip_dplm_tpu_torch.models.layers import Dense, Embed, LayerNorm, numpy_f32

NEG_INF = -1e9

# base vocabulary: specials, then nucleotides (T is read as U)
RNA_VOCAB: List[str] = ["<pad>", "<mask>", "<cls>", "<eos>", "A", "U", "G", "C", "<unk>"]
RNA_TOKEN_TO_ID = {t: i for i, t in enumerate(RNA_VOCAB)}
RNA_PAD_IDX = 0
RNA_UNK_IDX = RNA_TOKEN_TO_ID["<unk>"]


def tokenize_rna(seq: str, max_len: Optional[int] = None) -> np.ndarray:
    """RNA (or DNA) sequence -> int32 base ids, T mapped to U, no specials."""
    seq = "".join(seq.split()).upper().replace("T", "U")
    ids = [RNA_TOKEN_TO_ID.get(c, RNA_UNK_IDX) for c in seq]
    if max_len is not None:
        ids = ids[:max_len]
    return np.asarray(ids, dtype=np.int32)


def tokenize_rna_batch(seqs: Sequence[str], max_len: Optional[int] = None,
                       pad_multiple: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """((B, S) ids, (B, S) mask), S the longest rounded up to pad_multiple."""
    toks = [tokenize_rna(s, max_len) for s in seqs]
    L = max(len(t) for t in toks)
    S = ((L + pad_multiple - 1) // pad_multiple) * pad_multiple
    out = np.full((len(toks), S), RNA_PAD_IDX, dtype=np.int32)
    mask = np.zeros((len(toks), S), dtype=bool)
    for i, t in enumerate(toks):
        out[i, : len(t)] = t
        mask[i, : len(t)] = True
    return out, mask


class BertBlock(nn.Module):
    """Post-LN BERT encoder layer (HF BertLayer semantics)."""

    def __init__(self, cfg: RNABertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.q, self.k, self.v, self.attn_out = (Dense(D, D, device=device) for _ in range(4))
        self.ln_attn = LayerNorm(D, cfg.layer_norm_eps, device=device)
        self.ffn_in = Dense(D, cfg.d_ff, device=device)
        self.ffn_out = Dense(cfg.d_ff, D, device=device)
        self.ln_ffn = LayerNorm(D, cfg.layer_norm_eps, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c, dtype = self.cfg, x.dtype
        H, Dh = c.num_heads, c.d_model // c.num_heads
        B, S, _ = x.shape

        def heads(t):
            return t.reshape(B, S, H, Dh).transpose(1, 2)

        logits = torch.einsum("bhqd,bhkd->bhqk", heads(self.q(x)).float(),
                              heads(self.k(x)).float()) / math.sqrt(Dh)
        logits = logits + torch.where(mask[:, None, None, :], 0.0, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        attn = torch.einsum("bhqk,bhkd->bhqd", probs.float(), heads(self.v(x)).float()).to(dtype)
        attn = self.attn_out(attn.transpose(1, 2).reshape(B, S, c.d_model))
        x = self.ln_attn(x + attn).to(dtype)
        h = self.ffn_out(F.gelu(self.ffn_in(x)))
        return self.ln_ffn(x + h).to(dtype)


class RNABertTower(nn.Module):
    """BERT encoder over RNA base ids (B, S) with a (B, S) validity mask:
    (B, S, 120) per-base embeddings, f32, or their masked mean. `dtype` is
    the compute dtype of the blocks."""

    def __init__(self, cfg: RNABertConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.word_embeddings = Embed(cfg.vocab_size, cfg.d_model, device=device)
        self.position_embeddings = Embed(cfg.max_len, cfg.d_model, device=device)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.d_model, device=device)
        self.embed_ln = LayerNorm(cfg.d_model, cfg.layer_norm_eps, device=device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertBlock(cfg, device))

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.embedding.device

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                pooling: str = "tokens") -> torch.Tensor:
        if mask is None:
            mask = tokens != RNA_PAD_IDX
        S = tokens.shape[1]
        emb = (self.word_embeddings(tokens)
               + self.position_embeddings.embedding[:S][None]
               + self.token_type_embeddings.embedding[0])
        h = torch.where(mask[..., None], self.embed_ln(emb), 0.0).to(self.dtype)
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h, mask)
        h = h.float()
        if pooling == "tokens":
            return h
        if pooling == "mean":
            w = mask[..., None].float()
            return (h * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
        raise ValueError(f"unknown pooling {pooling!r}")


def _bert_hf_names(cfg: RNABertConfig) -> Dict[str, str]:
    """The port's RNABertTower state_dict names -> HF `BertModel` names."""
    names = {f"{e}.embedding": f"embeddings.{e}.weight"
             for e in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    names.update({"embed_ln.scale": "embeddings.LayerNorm.weight",
                  "embed_ln.bias": "embeddings.LayerNorm.bias"})
    sites = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "attn_out": "attention.output.dense",
             "ln_attn": "attention.output.LayerNorm", "ffn_in": "intermediate.dense",
             "ffn_out": "output.dense", "ln_ffn": "output.LayerNorm"}
    for i in range(cfg.num_layers):
        for site, hf in sites.items():
            first = "scale" if site.startswith("ln") else "kernel"
            names[f"layer_{i}.{site}.{first}"] = f"encoder.layer.{i}.{hf}.weight"
            names[f"layer_{i}.{site}.bias"] = f"encoder.layer.{i}.{hf}.bias"
    return names



def convert_bert_torch_params(state_dict, cfg: RNABertConfig) -> Dict[str, torch.Tensor]:
    """HF `BertModel.state_dict()` (torch tensors or numpy arrays) -> the
    port's RNABertTower state_dict, f32 on the CPU (nothing transposed)."""
    return {k: torch.from_numpy(numpy_f32(state_dict[v])) for k, v in _bert_hf_names(cfg).items()}


def export_bert_torch_params(params, cfg: RNABertConfig) -> Dict[str, np.ndarray]:
    """Inverse of `convert_bert_torch_params`: an RNABertTower (or its
    state_dict) -> an HF `BertModel` state_dict, numpy f32, equal to the JAX
    package's `export_bert_torch_params` of the same weights."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    return {hf: numpy_f32(sd[name]) for name, hf in _bert_hf_names(cfg).items()}
