"""Fixed-step ODE integration of a learned vector field: Euler, Heun, RK4.

Counterpart of `clip_dplm_tpu/ops/integrate.py`: the reference's
`lax.scan` is a Python loop on the state's device, under `torch.no_grad`
unless the caller asks for gradients (`grad=True`). The times are formed in
f32 as the reference forms them (t0 + i * dt, then t + dt and t + dt/2), so
the field sees the same t on every device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import numpy as np
import torch

VectorField = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x, t) -> dx/dt
METHODS = ("euler", "heun", "rk4")


def integrate(vf: VectorField, x0: torch.Tensor, t0: float = 0.0, t1: float = 1.0,
              num_steps: int = 50, method: str = "heun", return_trajectory: bool = True,
              grad: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate dx/dt = vf(x, t) from t0 to t1 in num_steps fixed steps.
    Returns (x_final, trajectory): the trajectory is (num_steps + 1, ...)
    with the initial state first, or empty without return_trajectory."""
    if method not in METHODS:
        raise ValueError(f"unknown integration method {method!r}; one of {METHODS}")
    dt = (t1 - t0) / num_steps
    f32 = np.float32
    B = x0.shape[0]

    def t_vec(t) -> torch.Tensor:
        return torch.full((B,), float(t), dtype=torch.float32, device=x0.device)

    def step(x, t):
        if method == "euler":
            return x + dt * vf(x, t_vec(t))
        if method == "heun":
            k1 = vf(x, t_vec(t))
            k2 = vf(x + dt * k1, t_vec(t + f32(dt)))
            return x + 0.5 * dt * (k1 + k2)
        half = t + f32(0.5 * dt)
        k1 = vf(x, t_vec(t))
        k2 = vf(x + 0.5 * dt * k1, t_vec(half))
        k3 = vf(x + 0.5 * dt * k2, t_vec(half))
        k4 = vf(x + dt * k3, t_vec(t + f32(dt)))
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    ctx = contextlib.nullcontext() if grad else torch.no_grad()
    with ctx:
        x, traj = x0, [x0]
        for i in range(num_steps):
            x = step(x, f32(t0) + f32(i) * f32(dt))
            if return_trajectory:
                traj.append(x)
    if return_trajectory:
        return x, torch.stack(traj)
    return x, x0.new_zeros((0,))
