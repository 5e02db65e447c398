"""Timing of a train step on one CUDA device:
`python -m clip_dplm_tpu_torch.experiments.bench [--model
two_tower|two_tower_cached|rna_rbp|esm_clip|tf_clip|triple_flow|dplm] [--batch B]
[--iters N] [-o a.b=c ...]`.

Counterpart of the repository's `bench.py` legs:
- `two_tower` (default, B=8192): towers 256/1280 -> 1024, 3 layers, relu;
  optimized projection 512 / 2048, tanh-GELU, dropout 0.1; every Dense+LN
  block and the InfoNCE loss fused;
- `two_tower_cached` (B=8192): `two_tower` with the hard-negative cache of
  the `two_tower_optimized` preset (8192 rows). The first warm-up step fills
  the cache, so every timed step's a->b direction sees B + 8192 = 16384
  columns (the fused row cross-entropy, both directions);
- `rna_rbp` (B=1024, `BENCH_MODEL=rna_rbp`): the flagship token transformer,
  towers 120/1280 -> 512, 3 blocks of 8 heads over 127 tokens plus the CLS
  token (S = 128), ragged lengths in [63, 127); fused projection blocks and
  fused InfoNCE; both with bf16 Adam moments;
- `tf_clip` (B=4096): the three-way cell <-> perturbation <-> protein model
  of `scripts/tpu_config_probes.py`'s probe at the default widths (three
  encoders of 3 blocks, 8 heads, d=512; gene_dim 2000 + 1, esm_dim 1280,
  10 DEG tokens), its batch (kNN connectivity through the gram identity)
  and its overrides: the fused InfoNCE, f32 Adam moments. The metric is
  cells/s: one (cell, perturbation, protein) triple per batch row;
- `esm_clip` (B=64): the RNA <-> protein CLIP with an ESM-2 8M tower
  (configs/esm_clip.yaml: the tower trained, 320 wide, 6 layers of 20
  heads) over 64 protein tokens, the RNA tower (512 wide, 3 blocks of 8
  heads) over 32 tokens plus CLS, the heads' Dense blocks fused, the plain
  InfoNCE (the config's `use_fused_kernel: false`). The metric is pairs/s;
- `dplm` (B=256): DPLM 640/12/10 diffusion training at S = 128 (up to 126
  residues plus cls/eos, the serving path's length), a motif-tiled batch
  with ragged lengths in [64, 126) (`registry.motif_proteins`), f32 Adam
  moments. The packed attention takes the saved-probabilities mode there
  (JAX's padded count: 256·10·128²·2 = 84 MB a call). The metric is
  sequences/s;
- `triple_flow` (B=256): the encoders with OT-CFM flows at the widths of
  configs/triple_flow.yaml (latent 512, the PiGNN of 3 layers and 8 heads,
  gene_dim 2000, esm_dim 1280, proteins 1280 -> 1024 -> 768 -> 512, flows
  512 -> 1024 x 3, exact OT) and its overrides (a fixed temperature of 0.1,
  lr 1e-4, weight decay 1e-5), in f32 as the reference runs it; the batch
  is the first training batch of the host pipeline (`registry.
  _triple_flow_data`: a kNN subgraph of 256 cells, edges padded to 16 a
  node). Each step solves four 256 x 256 assignments on the host. The
  metric is cells/s, and the MFU is taken against the card's f32 peak
  (the step's matmuls are f32, outside the tensor cores).
All with exact clip 1.0, warmup-cosine. A fixed random batch made with
numpy from a seed, warm-up steps, then `--iters` chained train steps timed
with CUDA events. The last line of output is one JSON object with
bench.py's keys, its `peak_bf16_tflops` as `peak_tflops` and `peak_dtype`:
rows (pairs or cells) per second, the model FLOP/s from an analytic count
(matmuls only, backward = 2x forward) and the MFU against the card's dense
peak for the dtype of the step's matmuls (bf16, or float32 for
triple_flow), read from its name (H100 only: another card raises rather
than guess). Needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# bench.py's two-tower overrides, without the JAX PRNG choice
# (train.rng_impl), which has no torch meaning
OVERRIDES = [
    "tower_a.input_dim=256",
    "tower_a.hidden_size=1024",
    "tower_a.num_hidden_layers=3",
    "tower_b.input_dim=1280",
    "tower_b.hidden_size=1024",
    "tower_b.num_hidden_layers=3",
    "projection.dim=512",
    "train.optim.total_steps=1000",
    "contrastive.use_fused_kernel=true",
    "train.optim.moment_dtype=bfloat16",
    "tower_a.fused_dense=true",
    "tower_b.fused_dense=true",
    "projection.fused_dense=true",
]

# bench.py's flagship overrides (`run_flagship`), without train.rng_impl and
# train.optim.fused_update=true (the port's default too)
TOKENS = 127  # per tower; the CLS token makes S = 128
RNA_RBP_OVERRIDES = [
    "experiment=rna_rbp",
    "rna_tower.input_dim=120", "rna_tower.d_model=512",
    "rna_tower.num_layers=3", "rna_tower.num_heads=8",
    f"rna_tower.max_len={TOKENS + 1}",
    "rbp_tower.input_dim=1280", "rbp_tower.d_model=512",
    "rbp_tower.num_layers=3", "rbp_tower.num_heads=8",
    f"rbp_tower.max_len={TOKENS + 1}",
    "projection.dim=512",
    "train.optim.total_steps=1000",
    "train.optim.moment_dtype=bfloat16",
    "contrastive.use_fused_kernel=true",
    "projection.fused_dense=true",
]

# the two_tower_optimized preset: configs/two_tower.yaml plus these two lines
PRESET_OVERRIDES = ["contrastive.use_cache=true", "contrastive.use_fused_kernel=true"]
# two_tower with the preset's hard-negative cache (8192 rows)
CACHED_OVERRIDES = OVERRIDES + PRESET_OVERRIDES + ["contrastive.cache_size=8192"]

# the tf_clip probe's overrides (scripts/tpu_config_probes.py::tf_clip_fixture)
# without train.rng_impl (no torch meaning) and train.optim.fused_update=true
# (the port's default too)
TF_CLIP_OVERRIDES = [
    "experiment=tf_clip",
    "train.optim.total_steps=1000",
    "contrastive.use_fused_kernel=true",
]

# configs/esm_clip.yaml's differences from the default config (the ESM tower
# trained, B=64), with the heads' Dense blocks fused as the flagship's bench
# has them
ESM_CLIP_OVERRIDES = ["experiment=esm_clip", "esm.frozen=false", "train.optim.total_steps=1000",
                      "projection.fused_dense=true"]
ESM_CLIP_RNA, ESM_CLIP_PROTEIN = 32, 64  # tokens, as registry._esm_clip_data has them

# configs/triple_flow.yaml's differences from the port's defaults that the
# family reads (its grad_accum_steps, schedule and widths are the defaults)
TRIPLE_FLOW_OVERRIDES = [
    "experiment=triple_flow",
    "contrastive.learned_temperature=false", "contrastive.temperature=0.1",
    "train.optim.learning_rate=1e-4", "train.optim.weight_decay=1e-5",
    "train.optim.total_steps=1000",
]

DPLM_SEQ = 128  # 126 residues + cls/eos
DPLM_OVERRIDES = ["experiment=dplm", f"dplm.max_len={DPLM_SEQ}", "train.optim.total_steps=1000"]

# untimed steps before the timed ones: the first builds the kernels
WARMUP_STEPS = 3

# dense peaks (NVIDIA data sheets) by dtype and device-name marker: bf16 on
# the tensor cores, float32 outside them
_H100_PEAKS = {
    "bfloat16": (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12)),
    "float32": (("H100 PCIe", 51e12), ("H100 NVL", 60e12), ("H100", 67e12)),
}


def peak_flops(device_name: str, dtype: str) -> float:
    for marker, peak in _H100_PEAKS[dtype]:
        if marker in device_name:
            return peak
    raise ValueError(f"no {dtype} peak known for {device_name!r} (H100 only)")


def two_tower_step_flops(cfg, batch: int) -> float:
    """bench.py's analytic matmul FLOPs for fwd+bwd of one train step."""

    def dense(m, n, k):
        return 2.0 * m * n * k

    def tower(t, B):
        return dense(B, t.hidden_size, t.input_dim) + (t.num_hidden_layers - 1) * dense(
            B, t.hidden_size, t.hidden_size)

    def proj(in_dim, p, B):
        hidden = p.hidden_dim or 4 * p.dim
        return (dense(B, p.dim, in_dim) + dense(B, hidden, in_dim)
                + dense(B, hidden, hidden) + dense(B, p.dim, hidden))

    fwd = tower(cfg.tower_a, batch) + tower(cfg.tower_b, batch)
    fwd += proj(cfg.tower_a.hidden_size, cfg.projection, batch)
    fwd += proj(cfg.tower_b.hidden_size, cfg.projection, batch)
    fwd += dense(batch, batch, cfg.projection.dim)
    return 3.0 * fwd


def two_tower_cached_step_flops(cfg, batch: int) -> float:
    """two_tower_step_flops with the loss's products taken against the B + C
    columns of the a->b direction (the b->a direction's B x B similarity is
    the transpose of its first B columns, counted once as in the symmetric
    loss)."""
    return two_tower_step_flops(cfg, batch) + 3.0 * 2.0 * batch * (
        cfg.contrastive.cache_size * cfg.projection.dim)


def token_clip_step_flops(cfg, B: int, sa: int, sb: int) -> float:
    """bench.py's analytic matmul FLOPs (fwd+bwd ~= 3x fwd) of the RNA<->RBP
    token transformer CLIP step; attention's backward recompute is not
    credited."""

    def tower(tc, S, extra_cls=1):
        S = S + extra_cls
        f = 2.0 * B * S * tc.input_dim * tc.d_model  # input proj
        per_layer = 24.0 * B * S * tc.d_model**2 + 4.0 * B * S * S * tc.d_model
        return f + tc.num_layers * per_layer

    def proj(in_dim, pcfg):
        hidden = pcfg.hidden_dim or 4 * pcfg.dim
        f = 2.0 * B * pcfg.dim * in_dim
        f += 2.0 * B * (hidden * in_dim + hidden * hidden + pcfg.dim * hidden)
        return f

    fwd = tower(cfg.rna_tower, sa) + tower(cfg.rbp_tower, sb)
    fwd += proj(cfg.rna_tower.d_model, cfg.projection)
    fwd += proj(cfg.rbp_tower.d_model, cfg.projection)
    fwd += 2.0 * B * B * cfg.projection.dim
    return 3.0 * fwd


def esm_clip_step_flops(cfg, B: int) -> float:
    """Analytic matmul FLOPs (fwd+bwd ~= 3x fwd) of one esm_clip step: the
    RNA token tower over ESM_CLIP_RNA tokens plus CLS (input projection and
    each layer's 24·T·d² and 4·B·S²·d), the ESM tower's layers over
    ESM_CLIP_PROTEIN tokens, both optimized heads and the B x B
    similarity."""
    r, e, p = cfg.rna_tower, cfg.esm, cfg.projection
    hidden = p.hidden_dim or 4 * p.dim

    def layers(n, S, d):
        return n * (24.0 * B * S * d * d + 4.0 * B * S * S * d)

    def proj(in_dim):
        return 2.0 * B * (p.dim * in_dim + hidden * in_dim + hidden * hidden + p.dim * hidden)

    S = ESM_CLIP_RNA + 1
    fwd = 2.0 * B * S * r.input_dim * r.d_model + layers(r.num_layers, S, r.d_model)
    fwd += layers(e.num_layers, ESM_CLIP_PROTEIN, e.d_model)
    fwd += proj(r.d_model) + proj(e.d_model) + 2.0 * B * B * p.dim
    return 3.0 * fwd


def esm_clip_batch(cfg, B: int, rng) -> Dict[str, np.ndarray]:
    """B pairs of the esm_clip data's shapes: RNA token embeddings (B,
    ESM_CLIP_RNA, input_dim), all valid; protein rows of ESM_CLIP_PROTEIN
    tokens (<cls>, residues, <eos>, <pad>) with lengths in [S/2, S-2), drawn
    lengths first."""
    from clip_dplm_tpu_torch.models.dplm import CLS_IDX, EOS_IDX, PAD_IDX

    S = ESM_CLIP_PROTEIN
    lens = rng.integers(S // 2, S - 2, B)
    tokens = np.full((B, S), PAD_IDX, np.int32)
    tokens[:, 0] = CLS_IDX
    tokens[:, 1:S - 1] = rng.integers(4, 24, (B, S - 2))
    tokens[np.arange(B), 1 + lens] = EOS_IDX
    tokens[np.arange(S)[None, :] > 1 + lens[:, None]] = PAD_IDX
    return {
        "rna_tokens": rng.normal(size=(B, ESM_CLIP_RNA, cfg.rna_tower.input_dim)).astype(
            np.float32),
        "rna_mask": np.ones((B, ESM_CLIP_RNA), bool),
        "protein_tokens": tokens,
        "protein_mask": tokens != PAD_IDX,
    }


def tf_clip_step_flops(cfg, B: int) -> float:
    """Analytic matmul FLOPs (fwd+bwd ~= 3x fwd) of one tf_clip step: every
    Dense (2·m·n·k), each encoder layer's 24·T·d² over its T tokens plus the
    attention's 4·N·S²·d over N sequences of S tokens (the cell tower is one
    sequence of S = B cells, the perturbation tower B of T genes, the
    protein tower B of one token), the three optimized heads and the three
    B x B similarities. At the default widths and B=4096: 1.316 TFLOP
    forward, 3.947 TFLOP a step."""
    d, enc, pc = cfg.projection.dim, cfg.encoders, cfg.projection
    T, layers = enc.n_perturb_genes, 3  # tf_clip.py's encoder depth

    def encoder(n_seq, S):
        return layers * (24.0 * n_seq * S * d * d + 4.0 * n_seq * S * S * d)

    hidden = pc.hidden_dim or 4 * pc.dim
    head = 2.0 * B * (d * pc.dim + d * hidden + hidden * hidden + hidden * pc.dim)
    fwd = 2.0 * B * (enc.gene_dim + 1) * d + 2.0 * B * d * d  # cell_in
    fwd += 2.0 * B * T * (enc.esm_dim + 1) * d + 2.0 * B * enc.esm_dim * d  # token inputs
    fwd += encoder(1, B) + encoder(B, T) + encoder(B, 1)
    fwd += 3 * head + 3 * 2.0 * B * B * pc.dim
    return 3.0 * fwd


def tf_clip_batch(cfg, B: int, rng) -> Dict[str, np.ndarray]:
    """The tf_clip probe's batch (`tpu_config_probes.py::tf_clip_fixture`):
    cell states, their kNN connectivity through the gram identity (the
    pairwise broadcast does not scale to B=4096), then the DEG ESM tokens,
    their values and the protein embedding, drawn in that order."""
    enc = cfg.encoders
    x = rng.normal(size=(B, enc.gene_dim + 1)).astype(np.float32)
    sq = (x * x).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    kth = np.partition(d2, 8, axis=1)[:, 8]
    conn = (d2 <= kth[:, None]).astype(np.float32)
    np.fill_diagonal(conn, 0.0)
    return {
        "cell_state": x,
        "connectivity": np.maximum(conn, conn.T),
        "gene_esm": rng.normal(size=(B, enc.n_perturb_genes, enc.esm_dim)).astype(np.float32),
        "gene_values": rng.uniform(-1, 1, (B, enc.n_perturb_genes)).astype(np.float32),
        "protein_emb": rng.normal(size=(B, enc.esm_dim)).astype(np.float32),
    }


def dplm_step_flops(cfg, B: int, S: int = DPLM_SEQ) -> float:
    """Analytic matmul FLOPs (fwd+bwd ~= 3x fwd) of one DPLM train step over
    T = B·S tokens: each layer's 24·T·d² (qkv, out, the 4x FFN) and its
    attention's 4·B·S²·d, and the LM head's 2·T·d·vocab. At 640/12/10, B=256,
    S=128: 11.98 TFLOP a step."""
    c = cfg.dplm
    T = B * S
    fwd = c.num_layers * (24.0 * T * c.d_model ** 2 + 4.0 * B * S * S * c.d_model)
    fwd += 2.0 * T * c.d_model * c.vocab_size
    return 3.0 * fwd


def dplm_batch(cfg, B: int, rng) -> Dict[str, np.ndarray]:
    """B motif-tiled rows of DPLM_SEQ tokens (`registry.motif_proteins`)."""
    from clip_dplm_tpu_torch.experiments.registry import motif_proteins
    from clip_dplm_tpu_torch.models.dplm import PAD_IDX

    tokens = motif_proteins(rng, B, DPLM_SEQ)
    return {"tokens": tokens, "mask": tokens != PAD_IDX}


def triple_flow_batch(cfg, B: int, rng) -> Dict[str, np.ndarray]:
    """The first training batch of the family's host pipeline at batch B,
    shuffled by a seed from `rng`."""
    from clip_dplm_tpu_torch.experiments.registry import build_data

    train, _ = build_data(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=B)))
    return next(iter(train(seed=int(rng.integers(1 << 31)))))


def triple_flow_flops(cfg, B: int) -> float:
    from clip_dplm_tpu_torch.models.triple_flow_model import triple_flow_step_flops

    return triple_flow_step_flops(cfg, B, 16 * B)


def _two_tower_batch(cfg, B: int, rng) -> Dict[str, np.ndarray]:
    return {"a": rng.normal(size=(B, cfg.tower_a.input_dim)).astype(np.float32),
            "b": rng.normal(size=(B, cfg.tower_b.input_dim)).astype(np.float32)}


def rna_rbp_batch(cfg, B: int, rng) -> Dict[str, np.ndarray]:
    """bench.py's flagship batch: lengths in [63, 127) per side, then the
    token embeddings, drawn in that order."""
    la = rng.integers(TOKENS // 2, TOKENS, B)
    lb = rng.integers(TOKENS // 2, TOKENS, B)
    return {
        "rna_tokens": rng.normal(size=(B, TOKENS, cfg.rna_tower.input_dim)).astype(np.float32),
        "rna_mask": np.arange(TOKENS)[None, :] < la[:, None],
        "rbp_tokens": rng.normal(size=(B, TOKENS, cfg.rbp_tower.input_dim)).astype(np.float32),
        "rbp_mask": np.arange(TOKENS)[None, :] < lb[:, None],
    }


# --model -> (overrides, default batch, metric, unit, batch maker, step FLOPs,
# the dtype of the step's matmuls, whose peak the MFU is taken against)
MODELS = {
    "two_tower": (OVERRIDES, 8192, "contrastive_pairs_per_sec_per_chip", "pairs/s/chip",
                  _two_tower_batch, two_tower_step_flops, "bfloat16"),
    "two_tower_cached": (CACHED_OVERRIDES, 8192, "contrastive_cached_pairs_per_sec_per_chip",
                         "pairs/s/chip", _two_tower_batch, two_tower_cached_step_flops,
                         "bfloat16"),
    "rna_rbp": (RNA_RBP_OVERRIDES, 1024, "rna_rbp_pairs_per_sec_per_chip", "pairs/s/chip",
                rna_rbp_batch, lambda cfg, B: token_clip_step_flops(cfg, B, TOKENS, TOKENS),
                "bfloat16"),
    "esm_clip": (ESM_CLIP_OVERRIDES, 64, "esm_clip_pairs_per_sec_per_chip", "pairs/s/chip",
                 esm_clip_batch, esm_clip_step_flops, "bfloat16"),
    "tf_clip": (TF_CLIP_OVERRIDES, 4096, "tf_clip_cells_per_sec_per_chip", "cells/s/chip",
                tf_clip_batch, tf_clip_step_flops, "bfloat16"),
    "triple_flow": (TRIPLE_FLOW_OVERRIDES, 256, "triple_flow_cells_per_sec_per_chip",
                    "cells/s/chip", triple_flow_batch, triple_flow_flops, "float32"),
    "dplm": (DPLM_OVERRIDES, 256, "dplm_train_seqs_per_sec_per_chip", "seqs/s/chip",
             dplm_batch, dplm_step_flops, "bfloat16"),
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=sorted(MODELS), default="two_tower")
    p.add_argument("--batch", type=int, default=None,
                   help="default: 8192 for two_tower(_cached), 1024 for rna_rbp, 64 for "
                        "esm_clip, 4096 for tf_clip, 256 for triple_flow and dplm")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--override", "-o", action="append", default=[])
    return p.parse_args(argv)


def build_step(model: str, B: int, overrides: Sequence[str], device: torch.device):
    """The `--model` configuration at batch B with extra overrides, its
    train state, the seeded batch on `device` and the train step, after
    WARMUP_STEPS untimed steps: (cfg, state, batch, step)."""
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device

    base, _, _, _, make_batch, _, _ = MODELS[model]
    cfg = apply_overrides(Config(), base + [f"train.batch_size={B}"] + list(overrides))
    state = create_train_state(build_model(cfg, device=device), cfg)
    batch = to_device(make_batch(cfg, B, np.random.default_rng(0)), device)
    step = make_train_step(cfg)
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, batch)
    torch.cuda.synchronize(device)
    return cfg, state, batch, step


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the benchmark times the CUDA kernels: it needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(device)
    _, default_batch, metric, unit, _, step_flops, peak_dtype = MODELS[args.model]
    peak = peak_flops(name, peak_dtype)
    B = args.batch or default_batch
    cfg, state, batch, step = build_step(args.model, B, args.override, device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.iters):
        state, metrics = step(state, batch)
    end.record()
    torch.cuda.synchronize(device)
    dt = start.elapsed_time(end) / 1e3 / args.iters
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    fps = step_flops(cfg, B) / dt
    out = {
        "metric": metric,
        "value": round(B / dt, 2),
        "unit": unit,
        "vs_baseline": round(fps / (0.95 * peak), 4),
        "model_tflops_per_s_per_chip": round(fps / 1e12, 6),
        "mfu": round(fps / peak, 6),
        "peak_tflops": round(peak / 1e12, 1),
        "peak_dtype": peak_dtype,
        "step_ms": round(dt * 1e3, 4),
        "model": args.model,
        "batch": B,
        "loss": loss,
        "device": name,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
