"""Probe classifiers over concatenated CLIP embeddings, and the ablation
harness.

Counterpart of `clip_dplm_tpu/models/classifiers.py`: `LinearProbe`,
`SimpleNonLinearProbe`, `MLPProbe` (Dense, LayerNorm eps 1e-6, tanh GELU,
dropout, twice) and `TransformerProbe` (the embedding chunked into 8
tokens of width 128, two f32 `TransformerBlock`s of 4 heads, the token
mean); `PROBES`; `train_probe` (Adam on the frozen features, the JAX
package's batch draws from `np.random.default_rng(seed).integers`, dropout
seeds from (seed, step)); `evaluate_probe` and `ablation_study`. The
submodules carry flax's auto-names (`Dense_0`, `LayerNorm_0`, `block_0`,
...), so `utils/convert.py::load_flax_params` carries a flax probe's params
across. A flax module infers its input width at init; a port probe takes it
as `in_features`.

The transformer probe's attention (8 tokens, Dh = 32, f32) is the tiny-S
pair's f32 instance on the card (ops/tiny_attention.py). The probes run on
the device of the features they are given: `train_probe` and
`ablation_study` put them on the card unless the caller names the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_dplm_tpu_torch.models.layers import (
    FLAX_LN_EPS,
    Dense,
    LayerNorm,
    TransformerBlock,
    _dropout,
    init_params,
)
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds


class LinearProbe(nn.Module):
    def __init__(self, num_classes: int, in_features: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, num_classes, device=device)

    def forward(self, x, deterministic: bool = True, seeds: Optional[DropoutSeeds] = None):
        return self.Dense_0(x)


class SimpleNonLinearProbe(nn.Module):
    def __init__(self, num_classes: int, in_features: int, hidden: int = 256, device=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden, device=device)
        self.Dense_1 = Dense(hidden, num_classes, device=device)

    def forward(self, x, deterministic: bool = True, seeds: Optional[DropoutSeeds] = None):
        return self.Dense_1(F.relu(self.Dense_0(x)))


class MLPProbe(nn.Module):
    def __init__(self, num_classes: int, in_features: int, hidden: int = 512,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.dropout = dropout
        dims = (in_features, hidden, hidden // 2)
        for i in range(2):
            self.add_module(f"Dense_{i}", Dense(dims[i], dims[i + 1], device=device))
            self.add_module(f"LayerNorm_{i}", LayerNorm(dims[i + 1], FLAX_LN_EPS, device=device))
        self.Dense_2 = Dense(dims[2], num_classes, device=device)

    def forward(self, x, deterministic: bool = True, seeds: Optional[DropoutSeeds] = None):
        for i in range(2):
            x = getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x))
            x = _dropout(F.gelu(x, approximate="tanh"), self.dropout, deterministic, seeds)
        return self.Dense_2(x)


class TransformerProbe(nn.Module):
    """Chunk the concatenated embedding into tokens, self-attend, pool."""

    def __init__(self, num_classes: int, in_features: int, d_model: int = 128,
                 num_tokens: int = 8, num_layers: int = 2, num_heads: int = 4, device=None):
        super().__init__()
        self.d_model, self.num_tokens, self.num_layers = d_model, num_tokens, num_layers
        self.Dense_0 = Dense(in_features, num_tokens * d_model, device=device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(d_model, num_heads,
                                                           dtype=torch.float32, device=device))
        self.Dense_1 = Dense(d_model, num_classes, device=device)

    def forward(self, x, deterministic: bool = True, seeds: Optional[DropoutSeeds] = None):
        h = self.Dense_0(x).reshape(x.shape[0], self.num_tokens, self.d_model)
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h, deterministic=deterministic, seeds=seeds)
        return self.Dense_1(h.mean(dim=1))


PROBES = {
    "linear": LinearProbe,
    "simple_nonlinear": SimpleNonLinearProbe,
    "mlp": MLPProbe,
    "transformer": TransformerProbe,
}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"device {device}: no CUDA device is available (pass device='cpu')")
    return device


def train_probe(probe: nn.Module, features: np.ndarray, labels: np.ndarray,
                num_steps: int = 200, lr: float = 1e-3, batch_size: int = 64, seed: int = 0,
                device="cuda", init: bool = True) -> nn.Module:
    """Fit a probe on frozen features with Adam (torch.optim.Adam, optax.adam's
    formula) on the softmax cross-entropy, and return it, trained in place on
    `device`. Batches are `np.random.default_rng(seed).integers(0, n,
    min(batch_size, n))`, one draw a step, as the JAX package draws them; step
    i's dropout takes DropoutSeeds(seed, i). With `init` the probe's weights
    are drawn first, on the CPU from `seed` (the same on every device);
    otherwise it keeps its own (carried from flax, say)."""
    device = _device(device)
    if init:
        probe.to("cpu")
        init_params(probe, torch.Generator().manual_seed(seed))
    probe.to(device).train()
    x = torch.as_tensor(np.asarray(features, np.float32), device=device)
    y = torch.as_tensor(np.asarray(labels), device=device).long()
    opt = torch.optim.Adam(probe.parameters(), lr=lr)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    for i in range(num_steps):
        sel = torch.as_tensor(rng.integers(0, n, min(batch_size, n)), device=device)
        loss = F.cross_entropy(probe(x[sel], deterministic=False,
                                     seeds=DropoutSeeds(seed, i)), y[sel])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return probe.eval()


@torch.no_grad()
def evaluate_probe(probe: nn.Module, features: np.ndarray, labels: np.ndarray) -> float:
    """Top-1 accuracy of the probe's deterministic forward, on its device."""
    device = next(probe.parameters()).device
    was_training = probe.training
    probe.eval()
    logits = probe(torch.as_tensor(np.asarray(features, np.float32), device=device))
    probe.train(was_training)
    y = torch.as_tensor(np.asarray(labels), device=device).long()
    return float((logits.argmax(dim=-1) == y).float().mean())


def ablation_study(embedding_fns: Dict[str, Callable[[], Dict[str, np.ndarray]]],
                   num_classes: int,
                   probe_names: Sequence[str] = ("linear", "simple_nonlinear", "mlp",
                                                 "transformer"),
                   num_steps: int = 200, device="cuda") -> Dict[str, Dict[str, float]]:
    """For each CLIP variant (an embedding_fn returning {train_x, train_y,
    test_x, test_y} over frozen concatenated embeddings), train every probe
    on `device` and report the accuracy grid {variant: {probe: accuracy}}."""
    results: Dict[str, Dict[str, float]] = {}
    for variant, fn in embedding_fns.items():
        data = fn()
        row = {}
        for name in probe_names:
            probe = PROBES[name](num_classes=num_classes,
                                 in_features=np.asarray(data["train_x"]).shape[1])
            probe = train_probe(probe, data["train_x"], data["train_y"], num_steps=num_steps,
                                device=device)
            row[name] = evaluate_probe(probe, data["test_x"], data["test_y"])
        results[variant] = row
    return results
