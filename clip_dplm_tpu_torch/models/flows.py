"""OT conditional flow matching (OT-CFM) between the encoders' latents.

Counterpart of `clip_dplm_tpu/models/flows.py`, in f32 as the JAX package
runs it:
- `sample_location_and_conditional_flow` pairs a source batch with a
  target batch by minibatch OT (ops/sinkhorn.py: exact Hungarian on the
  host, entropic Sinkhorn on the device, or independent), draws t ~ U(0, 1)
  and eps ~ N(0, 1), and returns (t, x_t, u_t):
    exact_ot / independent: x_t = (1-t) x0 + t x1 + sigma eps, u_t = x1 - x0
    sb: sigma_t = sigma sqrt(t(1-t)), x_t = mu_t + sigma_t eps,
        u_t = (1-2t) / (2 t(1-t)) (x_t - mu_t) + x1 - x0
  (the sb pairing's plan takes epsilon = 2 sigma^2). It is split into the
  draw (`flow_draw`) and `sample_location_and_conditional_flow_from_draw(x0,
  x1, idx, t, eps, ...)`, so a caller can feed any draw. JAX's PRNG draws
  cannot be matched: t, eps and the Sinkhorn plan's Gumbel noise come from
  the counter hash of (seed, row, col) (ops/fused_dense.py::dropout_bits)
  with four seeds of the step's `DropoutSeeds` per flow, eps by Box-Muller
  over two hash uniforms; t is equal bit for bit on the card and the CPU,
  eps and the noise up to the last bit of their logarithms and cosines.
- `VectorFieldNet`: the time MLP (1 -> time_dim -> latent) and an MLP over
  [x_t, u_t, t_emb] with LayerNorm / GELU / dropout and a tanh output;
  `velocity(x, t)` takes u_t = 0, as generation does.
- the regularizers: the path length mean ||v||^2 and the Frobenius norm of
  the net's Jacobian at the first sample (`torch.func.jacrev`,
  differentiable in training).
- `OTFlow` (one source -> target flow) and `TripleFlow` (cell -> pert,
  cell -> protein, pert -> protein, a flow skipped where its modality is
  absent; the optional `feature_mixer`).
Parameter names are the flax modules' (`time_fc0`, `fc{i}`, `ln{i}`, `out`;
an OTFlow's net under `net`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from clip_dplm_tpu_torch.config import FlowConfig
from clip_dplm_tpu_torch.models.gnn import gelu
from clip_dplm_tpu_torch.models.layers import FLAX_LN_EPS, Dense, LayerNorm, _dropout
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds, dropout_bits
from clip_dplm_tpu_torch.ops.sinkhorn import ot_pairing

FLOW_TYPES = ("exact_ot", "sb", "independent")


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 hash values -> f32 in [0, 1) from their top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def flow_draw(seeds: DropoutSeeds, B: int, D: int, device=None
              ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """The draw of one flow from the next four seeds: (the pairing's seed,
    t (B,) f32 in [0, 1), eps (B, D) f32 standard normal)."""
    pair_seed, t_seed, s1, s2 = (seeds.next() for _ in range(4))
    t = _uniform(dropout_bits(t_seed, B, 1, device)[:, 0])
    u1 = 1.0 - _uniform(dropout_bits(s1, B, D, device))  # (0, 1]: log(u1) is finite
    u2 = _uniform(dropout_bits(s2, B, D, device))
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return pair_seed, t, eps


def pairing_indices(x0: torch.Tensor, x1: torch.Tensor, flow_type: str, sigma: float,
                    sinkhorn_iters: int, seed: Optional[int]) -> torch.Tensor:
    """The target row paired with each source row under `flow_type`."""
    if flow_type == "exact_ot":
        return ot_pairing(x0, x1, method="exact")
    if flow_type == "sb":
        return ot_pairing(x0, x1, method="sinkhorn", epsilon=2.0 * sigma * sigma,
                          num_iters=sinkhorn_iters, seed=seed)
    if flow_type == "independent":
        return ot_pairing(x0, x1, method="independent")
    raise ValueError(f"unknown flow_type {flow_type!r}")


def sample_location_and_conditional_flow_from_draw(
        x0: torch.Tensor, x1: torch.Tensor, idx: torch.Tensor, t: torch.Tensor,
        eps: torch.Tensor, flow_type: str = "exact_ot", sigma: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(t, x_t, u_t) of the pairing `idx` and the draw (t, eps)."""
    if flow_type not in FLOW_TYPES:
        raise ValueError(f"unknown flow_type {flow_type!r}")
    x1 = x1[idx]
    t, eps = t.to(x0.dtype), eps.to(x0.dtype)
    tt = t[:, None]
    mu_t = (1.0 - tt) * x0 + tt * x1
    if flow_type == "sb":
        var = torch.clamp(tt * (1.0 - tt), min=1e-6)
        xt = mu_t + sigma * torch.sqrt(var) * eps
        ut = (1.0 - 2.0 * tt) / (2.0 * var) * (xt - mu_t) + (x1 - x0)
    else:
        xt = mu_t + sigma * eps
        ut = x1 - x0
    return t, xt, ut


def sample_location_and_conditional_flow(
        seeds: DropoutSeeds, x0: torch.Tensor, x1: torch.Tensor,
        flow_type: str = "exact_ot", sigma: float = 0.1, sinkhorn_iters: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(t, x_t, u_t, idx): the pairing and the draw from the next four
    seeds of `seeds`, then the conditional flow."""
    pair_seed, t, eps = flow_draw(seeds, x0.shape[0], x0.shape[1], x0.device)
    idx = pairing_indices(x0, x1, flow_type, sigma, sinkhorn_iters, pair_seed)
    t, xt, ut = sample_location_and_conditional_flow_from_draw(x0, x1, idx, t, eps,
                                                               flow_type, sigma)
    return t, xt, ut, idx


class VectorFieldNet(nn.Module):
    """v_theta(x_t, u_t, t)."""

    def __init__(self, cfg: FlowConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.latent_dim
        in_dim = 2 * D
        if cfg.use_time_embedding:
            self.time_fc0 = Dense(1, cfg.time_embed_dim, device=device)
            self.time_ln = LayerNorm(cfg.time_embed_dim, FLAX_LN_EPS, device=device)
            self.time_fc1 = Dense(cfg.time_embed_dim, D, device=device)
            in_dim += D
        for i in range(cfg.n_layers):
            self.add_module(f"fc{i}", Dense(in_dim if i == 0 else cfg.hidden_dim,
                                            cfg.hidden_dim, device=device))
            self.add_module(f"ln{i}", LayerNorm(cfg.hidden_dim, FLAX_LN_EPS, device=device))
        self.out = Dense(cfg.hidden_dim, D, device=device)

    def forward(self, xt: torch.Tensor, ut: torch.Tensor, t: torch.Tensor,
                deterministic: bool = True,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        c = self.cfg
        dt = self.out.kernel.dtype
        parts = [xt.to(dt), ut.to(dt)]
        if c.use_time_embedding:
            t_emb = gelu(self.time_ln(self.time_fc0(t[:, None].to(dt))).to(dt))
            parts.append(self.time_fc1(t_emb))
        h = torch.cat(parts, dim=-1)
        for i in range(c.n_layers):
            h = getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(h)).to(dt)
            h = _dropout(gelu(h), c.dropout, deterministic, seeds)
        return torch.tanh(self.out(h))

    def velocity(self, x: torch.Tensor, t: torch.Tensor, deterministic: bool = True,
                 seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """The inference-time field v(x, t), with u_t = 0."""
        return self(x, torch.zeros_like(x), t, deterministic, seeds)


def path_length_regularization(v: torch.Tensor) -> torch.Tensor:
    """mean ||v||^2."""
    return torch.mean(torch.sum(v * v, dim=-1))


def jacobian_regularization(net_fn, xt: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of the Jacobian of net_fn at the first sample,
    differentiable in the net's parameters."""
    jac = torch.func.jacrev(lambda x: net_fn(x[None])[0])(xt[0])
    return torch.sqrt(torch.sum(jac * jac))


def flow_matching_loss(v: torch.Tensor, target_v: torch.Tensor) -> torch.Tensor:
    """MSE."""
    return torch.mean((v - target_v) ** 2)


class OTFlow(nn.Module):
    """One source -> target CFM flow: draw (t, x_t, u_t), predict v."""

    def __init__(self, cfg: FlowConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.net = VectorFieldNet(cfg, device=device)

    def forward(self, seeds: DropoutSeeds, source: torch.Tensor, target: torch.Tensor,
                deterministic: bool = True,
                return_regularization: bool = False) -> Dict[str, torch.Tensor]:
        """{"v", "xt", "t", "ut", "idx" (the pairing), "regularization"
        (with return_regularization)}; the flow's draw takes the next four
        seeds, then the net's dropout sites theirs."""
        c = self.cfg
        dt = self.net.out.kernel.dtype
        t, xt, ut, idx = sample_location_and_conditional_flow(
            seeds, source.to(dt), target.to(dt), flow_type=c.flow_type, sigma=c.sigma,
            sinkhorn_iters=c.sinkhorn_iters)
        v = self.net(xt, ut, t, deterministic, seeds)
        out = {"v": v, "xt": xt, "t": t, "ut": ut, "idx": idx}
        if return_regularization:
            reg = v.new_zeros(())
            if c.use_path_length_reg:
                reg = reg + path_length_regularization(v)
            if c.use_jacobian_reg:
                reg = reg + jacobian_regularization(
                    lambda x: self.net(x, torch.zeros_like(x), x.new_zeros(x.shape[0])), xt)
            out["regularization"] = reg
        return out

    def velocity(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.net.velocity(x, t)


class TripleFlow(nn.Module):
    """Flows cell -> pert, cell -> protein and pert -> protein over the
    encoder latents, each run where both its modalities are present; with
    `use_feature_mixing` each source is conditioned on its target."""

    def __init__(self, cfg: FlowConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.cell_to_pert = OTFlow(cfg, device=device)
        self.cell_to_protein = OTFlow(cfg, device=device)
        self.pert_to_protein = OTFlow(cfg, device=device)
        if cfg.use_feature_mixing:
            self.feature_mixer = Dense(2 * cfg.latent_dim, cfg.latent_dim, device=device)

    def _mix(self, source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if not self.cfg.use_feature_mixing:
            return source
        dt = self.feature_mixer.kernel.dtype
        return source + self.feature_mixer(torch.cat([source, target], dim=-1).to(dt))

    def forward(self, seeds: DropoutSeeds, embeddings: Dict[str, torch.Tensor],
                deterministic: bool = True, return_regularization: bool = False,
                ) -> Dict[str, Dict[str, torch.Tensor]]:
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        cell = embeddings.get("cell_emb")
        pert = embeddings.get("pert_emb")
        protein = embeddings.get("protein_emb")
        for name, src, tgt in (("cell_to_pert", cell, pert),
                               ("cell_to_protein", cell, protein),
                               ("pert_to_protein", pert, protein)):
            if src is not None and tgt is not None:
                out[name] = getattr(self, name)(seeds, self._mix(src, tgt), tgt,
                                                deterministic, return_regularization)
        return out
