"""Input-convex neural networks (Brenier potentials) and transport maps.

Counterpart of `clip_dplm_tpu/models/icnn.py`, in f32 (f64 for f64
inputs):
- `ConvexLayer`: y = act(LN(W x + scale * softplus(V + eps) z)); W
  unconstrained with an orthogonal init (`linear`), the z-path weights V
  kept raw as an (in, out) parameter `pos_weights` and made positive by the
  softplus, `scale` a softplus of its raw value under `strict_convex`; in
  training the mean |z contribution| is clamped to `gradient_clip` by a
  factor computed under `torch.no_grad` (it takes no gradient, as the
  reference's stop-gradient);
- `SingleCellICNN`: the input LayerNorm, the ConvexLayer chain and the
  scalar potential Psi (positive final weights under `strict_convex`);
- `icnn_gradient` (T = grad Psi) and `icnn_hessian` (per sample, vmap of
  jacfwd of grad), through `torch.func`;
- `transport_cost`: the mean L2 plus the L1 sparsity;
- `SingleCellTransport`: input LayerNorm, T = grad Psi, output LayerNorm. The
  reference's lifted `nn.grad` is `torch.autograd.grad` under
  `torch.enable_grad()`: with the caller's gradient mode on (training) it
  keeps the graph (`create_graph=True`), so the loss differentiates through
  T; under `torch.no_grad` (evaluation) it builds no graph and returns T
  detached;
- `TripleTransportMaps`: the maps cell -> pert, cell -> protein and pert
  -> protein, with the consistency loss T_CE(x) ~ T_PE(T_CP(x)) of the
  composed maps in training; `total_transport_loss`.
LayerNorm eps is flax's 1e-6. LayerNorm (the reference's default) breaks
convexity in x; with `use_layer_norm=False` Psi is convex by construction.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clip_dplm_tpu_torch.config import ICNNConfig
from clip_dplm_tpu_torch.models.layers import FLAX_LN_EPS, Dense, LayerNorm
from clip_dplm_tpu_torch.ops.infonce import at_least_f32


def _softplus_inverse(y: float) -> float:
    return math.log(math.expm1(y))


class OrthogonalDense(Dense):
    """A Dense whose kernel initializes orthogonal (flax's
    `initializers.orthogonal()`)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            rows, cols = self.kernel.shape
            flat = torch.randn(max(rows, cols), min(rows, cols), generator=generator,
                               device=self.kernel.device, dtype=torch.float32)
            q, r = torch.linalg.qr(flat)
            q = q * torch.sign(torch.diagonal(r))[None, :]
            self.kernel.copy_(q if rows >= cols else q.t())
            self.bias.zero_()


class ConvexLayer(nn.Module):
    def __init__(self, cfg: ICNNConfig, x_dim: int, output_dim: int,
                 z_dim: Optional[int] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.linear = OrthogonalDense(x_dim, output_dim, device=device)
        if z_dim is not None:
            self.pos_weights = nn.Parameter(torch.zeros(z_dim, output_dim, device=device))
            self.scale = nn.Parameter(torch.zeros(1, device=device))
        if cfg.use_layer_norm:
            self.norm = LayerNorm(output_dim, FLAX_LN_EPS, device=device)
        self.reset_own_params()

    def reset_own_params(self, generator: Optional[torch.Generator] = None) -> None:
        if hasattr(self, "pos_weights"):
            with torch.no_grad():
                self.pos_weights.zero_()
                c = self.cfg
                self.scale.fill_(_softplus_inverse(c.init_scale) if c.strict_convex
                                 else c.init_scale)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        c = self.cfg
        y = self.linear(x)
        if z is not None:
            scale = F.softplus(self.scale) if c.strict_convex else self.scale
            w = F.softplus(self.pos_weights + c.eps)
            z_contrib = (z @ w.to(z.dtype)) * scale.to(z.dtype)
            if train:
                with torch.no_grad():
                    z_scale = torch.mean(torch.abs(z_contrib))
                    factor = torch.where(z_scale > c.gradient_clip, c.gradient_clip / z_scale,
                                         torch.ones_like(z_scale))
                z_contrib = z_contrib * factor
            y = y + z_contrib
        if c.use_layer_norm:
            y = self.norm(y)
        return F.softplus(y) if c.activation == "softplus" else F.celu(y)


class SingleCellICNN(nn.Module):
    """The scalar convex potential Psi(x): (B, input_dim) -> (B, 1)."""

    def __init__(self, cfg: ICNNConfig, input_dim: int, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.use_layer_norm:
            self.input_norm = LayerNorm(input_dim, FLAX_LN_EPS, device=device)
        z_dim = None
        for i, hidden in enumerate(cfg.hidden_dims):
            self.add_module(f"layer_{i}", ConvexLayer(cfg, input_dim, hidden, z_dim, device))
            z_dim = hidden
        if cfg.strict_convex:
            self.final_pos_weights = nn.Parameter(torch.zeros(z_dim, 1, device=device))
            self.final_bias = nn.Parameter(torch.zeros(1, device=device))
        else:
            self.final = Dense(z_dim, 1, device=device)

    def reset_own_params(self, generator: Optional[torch.Generator] = None) -> None:
        if self.cfg.strict_convex:
            with torch.no_grad():
                self.final_pos_weights.zero_()
                self.final_bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.cfg
        x = at_least_f32(x)
        if c.use_layer_norm:
            x = self.input_norm(x)
        z = None
        for i in range(len(c.hidden_dims)):
            z = getattr(self, f"layer_{i}")(x, z, train)
        if c.strict_convex:
            w = F.softplus(self.final_pos_weights + c.eps)
            return z @ w.to(z.dtype) + self.final_bias.to(z.dtype)
        return self.final(z)


def _clip_rows(g: torch.Tensor, clip: float) -> torch.Tensor:
    norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return torch.where(norm > clip, g * clip / torch.clamp(norm, min=1e-12), g)


def icnn_gradient(icnn: SingleCellICNN, x: torch.Tensor, train: bool = False,
                  clip: Optional[float] = None) -> torch.Tensor:
    """T(x) = grad Psi(x), (B, d); in training with `clip`, each row's norm
    clipped to it. Differentiable in the parameters (torch.func.grad)."""
    x = at_least_f32(x)
    g = torch.func.grad(lambda xx: icnn(xx, train).sum())(x)
    if train and clip:
        g = _clip_rows(g, clip)
    return g


def icnn_hessian(icnn: SingleCellICNN, x: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Per-sample Hessians (B, d, d) of Psi (+ reg I): vmap of jacfwd of
    grad, one forward sweep per input dimension."""
    x = at_least_f32(x)
    hess = torch.func.vmap(torch.func.jacfwd(torch.func.grad(
        lambda xx: icnn(xx[None], False)[0, 0])))(x)
    if reg:
        hess = hess + reg * torch.eye(x.shape[-1], dtype=hess.dtype, device=hess.device)
    return hess


def transport_cost(transported: torch.Tensor, target: torch.Tensor,
                   sparsity_weight: float = 0.01) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean L2 distance plus the L1 sparsity of both sides."""
    w2 = torch.linalg.vector_norm(transported - target, dim=-1).mean()
    sparsity = sparsity_weight * (transported.abs().sum(-1).mean()
                                  + target.abs().sum(-1).mean())
    return w2 + sparsity, {"w2_cost": w2, "sparsity_cost": sparsity}


class SingleCellTransport(nn.Module):
    """input LayerNorm -> T = grad Psi -> output LayerNorm; the output
    LayerNorm normalizes the target too, so output_dim must equal
    input_dim (as in the reference)."""

    def __init__(self, cfg: ICNNConfig, input_dim: int, output_dim: int, device=None):
        super().__init__()
        if output_dim != input_dim:
            raise ValueError(f"a transport map keeps its width: input_dim {input_dim} != "
                             f"output_dim {output_dim}")
        self.cfg = cfg
        self.transport_net = SingleCellICNN(cfg, input_dim, device=device)
        self.input_norm = LayerNorm(input_dim, FLAX_LN_EPS, device=device)
        self.output_norm = LayerNorm(input_dim, FLAX_LN_EPS, device=device)

    def forward(self, source: torch.Tensor, target: Optional[torch.Tensor] = None,
                train: bool = False) -> Dict[str, Any]:
        keep_graph = torch.is_grad_enabled()
        src = self.input_norm(source)
        with torch.enable_grad():
            if not src.requires_grad:
                src = src.detach().requires_grad_()
            psi = self.transport_net(src, train).sum()
            (grads,) = torch.autograd.grad(psi, src, create_graph=keep_graph)
        if train and self.cfg.gradient_clip:
            grads = _clip_rows(grads, self.cfg.gradient_clip)
        transported = self.output_norm(grads)
        if target is None:
            return {"transported": transported}
        cost, metrics = transport_cost(transported, self.output_norm(target),
                                       self.cfg.sparsity_weight)
        return {"transported": transported, "cost": cost, "metrics": metrics}

    def transport(self, source: torch.Tensor) -> torch.Tensor:
        return self(source)["transported"]


class TripleTransportMaps(nn.Module):
    """Brenier maps cell -> pert (T_CP), cell -> protein (T_CE) and pert ->
    protein (T_PE), with the consistency of the composition in training."""

    def __init__(self, cfg: ICNNConfig, cell_dim: int, pert_dim: int, protein_dim: int,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.cell_to_pert = SingleCellTransport(cfg, cell_dim, pert_dim, device)
        self.cell_to_protein = SingleCellTransport(cfg, cell_dim, protein_dim, device)
        self.pert_to_protein = SingleCellTransport(cfg, pert_dim, protein_dim, device)

    def forward(self, cell_states: torch.Tensor, pert_states: Optional[torch.Tensor] = None,
                protein_states: Optional[torch.Tensor] = None,
                train: bool = False) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if pert_states is not None:
            out["cell_to_pert"] = self.cell_to_pert(cell_states, pert_states, train)
        if protein_states is not None:
            out["cell_to_protein"] = self.cell_to_protein(cell_states, protein_states, train)
        if pert_states is not None and protein_states is not None:
            out["pert_to_protein"] = self.pert_to_protein(pert_states, protein_states, train)
            if train:
                composed = self.pert_to_protein(out["cell_to_pert"]["transported"],
                                                train=train)["transported"]
                direct = out["cell_to_protein"]["transported"]
                out["consistency_loss"] = torch.mean((direct - composed) ** 2)
        return out


def total_transport_loss(outputs: Dict[str, Any], consistency_weight: float = 0.1
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The maps' costs plus the weighted consistency."""
    total = None
    metrics: Dict[str, torch.Tensor] = {}
    for name in ("cell_to_pert", "cell_to_protein", "pert_to_protein"):
        if name in outputs and "cost" in outputs[name]:
            cost = outputs[name]["cost"]
            total = cost if total is None else total + cost
            metrics[f"{name}_w2"] = outputs[name]["metrics"]["w2_cost"]
    if "consistency_loss" in outputs:
        c = consistency_weight * outputs["consistency_loss"]
        total = c if total is None else total + c
        metrics["consistency"] = outputs["consistency_loss"]
    if total is None:
        total = torch.zeros(())
    return total, metrics
