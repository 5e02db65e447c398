"""Timing of the two-tower contrastive train step on one CUDA device:
`python -m clip_dplm_tpu_torch.experiments.bench [--batch 8192]`.

Counterpart of the two-tower leg of the repository's `bench.py`: the same
configuration (towers 256/1280 -> 1024, 3 layers, relu; optimized
projection 512 / 2048, tanh-GELU, dropout 0.1; every Dense+LN block and the
InfoNCE loss fused; bf16 Adam moments, exact clip 1.0, warmup-cosine), a
fixed random batch made with numpy from a seed, warm-up steps, then
`--iters` chained train steps timed with CUDA events. The last line of
output is one JSON object with bench.py's keys: pairs/s, the model FLOP/s
from bench.py's analytic count (matmuls only, backward = 2x forward) and
the MFU against the card's dense bf16 peak, read from its name (H100 only:
another card raises rather than guess). Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# the slice's configuration: bench.py's two-tower overrides, without the
# JAX PRNG choice (train.rng_impl), which has no torch meaning
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

# untimed steps before the timed ones: the first builds the kernels
WARMUP_STEPS = 3

# dense bf16 tensor-core peaks (NVIDIA data sheets), by device-name marker
_H100_PEAKS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12))


def peak_bf16_flops(device_name: str) -> float:
    for marker, peak in _H100_PEAKS:
        if marker in device_name:
            return peak
    raise ValueError(f"no bf16 peak known for {device_name!r} (H100 only)")


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


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--override", "-o", action="append", default=[])
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the benchmark times the CUDA kernels: it needs a CUDA device")
    from clip_dplm_tpu_torch.config import Config, apply_overrides
    from clip_dplm_tpu_torch.experiments.registry import build_model
    from clip_dplm_tpu_torch.train.state import create_train_state
    from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device

    device = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(device)
    peak = peak_bf16_flops(name)
    B = args.batch
    cfg = apply_overrides(Config(), OVERRIDES + [f"train.batch_size={B}"] + args.override)
    state = create_train_state(build_model(cfg, device=device), cfg)
    rng = np.random.default_rng(0)
    batch = to_device({
        "a": rng.normal(size=(B, cfg.tower_a.input_dim)).astype(np.float32),
        "b": rng.normal(size=(B, cfg.tower_b.input_dim)).astype(np.float32)}, device)
    step = make_train_step(cfg)
    for _ in range(WARMUP_STEPS):
        state, metrics = step(state, batch)
    torch.cuda.synchronize(device)
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
    fps = two_tower_step_flops(cfg, B) / dt
    out = {
        "metric": "contrastive_pairs_per_sec_per_chip",
        "value": round(B / dt, 2),
        "unit": "pairs/s/chip",
        "vs_baseline": round(fps / (0.95 * peak), 4),
        "model_tflops_per_s_per_chip": round(fps / 1e12, 6),
        "mfu": round(fps / peak, 6),
        "peak_bf16_tflops": round(peak / 1e12, 1),
        "step_ms": round(dt * 1e3, 4),
        "batch": B,
        "loss": loss,
        "device": name,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
