"""Minibatch optimal transport for the OT-CFM pairing.

Counterpart of `clip_dplm_tpu/ops/sinkhorn.py`:
- `pairwise_sqdist`: the squared euclidean cost (n, m), clamped at 0;
- `sinkhorn`: the log-domain Sinkhorn iterations, a Python loop of
  `torch.logsumexp` updates on the cost's device, differentiable;
- `sample_plan`: one target index per source row, drawn from each row of
  the coupling by the Gumbel-max trick. The Gumbel noise is the counter hash
  of (seed, row, col) (ops/fused_dense.py::dropout_bits), so the card and
  the CPU draw the same noise (up to the last bit of the logarithms); JAX's
  PRNG draws cannot be matched;
- `hungarian_pairing`: the exact assignment of a square cost, solved on the
  host by `scipy.optimize.linear_sum_assignment`, the JAX package's own
  design (a `pure_callback` there): the cost is built on its device and
  detached, and only the assignment crosses back. Each call is one host
  round trip, traced as `ot.hungarian_pairing` by torch.profiler;
- `ot_pairing`: `exact` (Hungarian), `sinkhorn` (entropic plan, sampled)
  or `independent` (the identity).
Everything computes in f32 (f64 for f64 inputs).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from clip_dplm_tpu_torch.ops.fused_dense import dropout_bits
from clip_dplm_tpu_torch.ops.infonce import at_least_f32


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean cost matrix (n, m)."""
    x, y = at_least_f32(x), at_least_f32(y)
    xx = torch.sum(x * x, dim=1)[:, None]
    yy = torch.sum(y * y, dim=1)[None, :]
    return torch.clamp(xx + yy - 2.0 * (x @ y.t()), min=0.0)


def sinkhorn(cost: torch.Tensor, epsilon: float = 0.05, num_iters: int = 100,
             a: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Log-domain Sinkhorn: (plan, f, g) with P = exp((f_i + g_j - C_ij) /
    eps), rows summing to a and columns to b (uniform by default)."""
    cost = at_least_f32(cost)
    n, m = cost.shape
    loga = (torch.log(torch.full((n,), 1.0 / n, dtype=cost.dtype, device=cost.device))
            if a is None else torch.log(a.to(cost.dtype)))
    logb = (torch.log(torch.full((m,), 1.0 / m, dtype=cost.dtype, device=cost.device))
            if b is None else torch.log(b.to(cost.dtype)))
    f = cost.new_zeros(n)
    g = cost.new_zeros(m)
    for _ in range(num_iters):
        f = epsilon * loga - epsilon * torch.logsumexp((g[None, :] - cost) / epsilon, dim=1)
        g = epsilon * logb - epsilon * torch.logsumexp((f[:, None] - cost) / epsilon, dim=0)
    plan = torch.exp((f[:, None] + g[None, :] - cost) / epsilon)
    return plan, f, g


def gumbel_noise(seed: int, rows: int, cols: int, device=None) -> torch.Tensor:
    """(rows, cols) f32 standard Gumbel noise -log(-log u) from the counter
    hash of (seed, row, col), u in (0, 1) from the top 24 bits."""
    u = ((dropout_bits(seed, rows, cols, device) >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_plan(seed: int, plan: torch.Tensor) -> torch.Tensor:
    """One target index per source row, categorical over each row of the
    coupling: argmax of log P + Gumbel noise."""
    logits = torch.log(torch.clamp(plan, min=1e-30))
    noise = gumbel_noise(seed, plan.shape[0], plan.shape[1], plan.device).to(logits.dtype)
    return torch.argmax(logits + noise, dim=1)


def hungarian_pairing(cost: torch.Tensor) -> torch.Tensor:
    """The exact OT assignment (a permutation) of a square cost, solved on
    the host; the cost is detached (the assignment is discrete). Returns
    int64 column indices on the cost's device."""
    n, m = cost.shape
    if n != m:
        raise ValueError(f"hungarian_pairing expects a square cost, got {n} x {m}")
    from scipy.optimize import linear_sum_assignment

    with torch.profiler.record_function("ot.hungarian_pairing"):
        host = cost.detach().to(torch.float32).cpu().numpy()
        with torch.profiler.record_function("ot.linear_sum_assignment"):
            _, col = linear_sum_assignment(host)
        return torch.from_numpy(col.astype(np.int64)).to(cost.device)


def ot_pairing(x0: torch.Tensor, x1: torch.Tensor, method: str = "exact",
               epsilon: float = 0.05, num_iters: int = 100,
               seed: Optional[int] = None) -> torch.Tensor:
    """Indices j(i) pairing each source row x0_i with a target row x1_j
    under the minibatch OT plan: exact (Hungarian, host) | sinkhorn
    (entropic, on the device; sampled with the Gumbel noise of `seed`) |
    independent (identity)."""
    if method == "independent":
        return torch.arange(x0.shape[0], device=x0.device)
    cost = pairwise_sqdist(x0, x1)
    if method == "exact":
        return hungarian_pairing(cost)
    if method == "sinkhorn":
        if seed is None:
            raise ValueError("the sinkhorn pairing needs a seed for its Gumbel noise")
        plan, _, _ = sinkhorn(cost, epsilon=epsilon, num_iters=num_iters)
        return sample_plan(seed, plan)
    raise ValueError(f"unknown OT pairing method {method!r}")
