"""TripleFlowModel: the tong encoders with OT-CFM flows between their
latents, and the family's losses.

Counterpart of `clip_dplm_tpu/models/triple_flow_model.py`, in f32 as the
JAX package builds it (no module of this family takes the port's bf16
kernels):
- `encode(batch)`: cell (CellStateEncoder over the batch's graph), pert
  (PerturbationEncoder) and protein (ProteinEncoder) latents, each where
  its inputs are in the batch;
- the training forward: the latents, the three flows of `TripleFlow` and a
  cell -> cell flow toward `cell_target_emb` when given, else toward the
  batch's own cells (the OT pairing then matches each cell with its
  nearest evolution);
- `generate_cell_trajectory`, `generate_protein_from_cell` and
  `generate_pert_from_cell`: the learned fields integrated from the given
  latents (ops/integrate.py);
- `compute_all_losses`: the three-way InfoNCE over the latents (at the
  fixed scale log(1/temperature)), each flow's matching MSE and its
  regularizer, weighted by train.loss_weights, with the reference's metric
  names.
The draws take seeds in call order from one `DropoutSeeds`: the encoders'
dropout, then each flow's draw and its net's dropout, in the order
cell_to_pert, cell_to_protein, pert_to_protein, cell_to_cell.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from clip_dplm_tpu_torch.config import Config
from clip_dplm_tpu_torch.models.flows import OTFlow, TripleFlow, flow_matching_loss
from clip_dplm_tpu_torch.models.tong_encoders import (
    CellStateEncoder,
    PerturbationEncoder,
    ProteinEncoder,
)
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.ops.infonce import at_least_f32, multiway_clip_loss
from clip_dplm_tpu_torch.ops.integrate import integrate


class TripleFlowModel(nn.Module):
    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.cell_encoder = CellStateEncoder(cfg.encoders, device=device)
        self.pert_encoder = PerturbationEncoder(cfg.encoders, device=device)
        self.protein_encoder = ProteinEncoder(cfg.encoders, device=device)
        self.flows = TripleFlow(cfg.flow, device=device)
        self.cell_to_cell = OTFlow(cfg.flow, device=device)

    @property
    def device(self) -> torch.device:
        return self.cell_to_cell.net.out.kernel.device

    def encode(self, batch: Dict[str, Any], deterministic: bool = True,
               seeds: Optional[DropoutSeeds] = None) -> Dict[str, torch.Tensor]:
        embs: Dict[str, torch.Tensor] = {}
        if "gene_expr" in batch:
            embs["cell_emb"] = self.cell_encoder(
                batch["gene_expr"], batch.get("dpt"), batch["edge_index"], batch["batch_idx"],
                batch.get("edge_mask"), batch.get("node_mask"), int(batch.get("num_graphs", 1)),
                deterministic, seeds)
        if "pert_esm" in batch and "pert_values" in batch:
            embs["pert_emb"] = self.pert_encoder(batch["pert_esm"], batch["pert_values"],
                                                 deterministic, seeds)
        if "protein_emb_raw" in batch:
            embs["protein_emb"] = self.protein_encoder(batch["protein_emb_raw"], deterministic,
                                                       seeds)
        return embs

    def forward(self, batch: Dict[str, Any], seeds: DropoutSeeds, deterministic: bool = True,
                return_regularization: bool = True) -> Dict[str, Dict]:
        """{"embeddings": the latents, "flows": {name: OTFlow outputs}}."""
        embs = self.encode(batch, deterministic, seeds)
        flows = self.flows(seeds, embs, deterministic, return_regularization)
        if "cell_emb" in embs:
            target = batch.get("cell_target_emb", embs["cell_emb"])
            flows["cell_to_cell"] = self.cell_to_cell(seeds, embs["cell_emb"], target,
                                                      deterministic, return_regularization)
        return {"embeddings": embs, "flows": flows}

    # -- generation: the learned fields conditioned on (x, t) only --

    def generate_cell_trajectory(self, cell_emb_1: torch.Tensor, cell_emb_2: torch.Tensor,
                                 num_steps: int = 50, method: str = "heun"):
        """Integrate the cell -> cell flow from state 1; state 2 is not read
        (the learned field defines the trajectory from x0)."""
        del cell_emb_2
        return integrate(self.cell_to_cell.velocity, cell_emb_1, num_steps=num_steps,
                         method=method)

    def generate_protein_from_cell(self, cell_emb: torch.Tensor, num_steps: int = 50,
                                   method: str = "heun"):
        """A cell latent carried into protein space along the cell -> protein
        flow."""
        return integrate(self.flows.cell_to_protein.velocity, cell_emb, num_steps=num_steps,
                         method=method)

    def generate_pert_from_cell(self, cell_emb: torch.Tensor, num_steps: int = 50,
                                method: str = "heun"):
        return integrate(self.flows.cell_to_pert.velocity, cell_emb, num_steps=num_steps,
                         method=method)


def compute_all_losses(outputs: Dict[str, Any], cfg: Config,
                       logit_scale: Optional[torch.Tensor] = None):
    """(total, metrics): loss_weights.contrastive x the three-way InfoNCE,
    + flow x each flow's MSE (`flow_{name}`), + regularization x each
    flow's regularizer (`reg_{name}`)."""
    w = cfg.train.loss_weights
    embs = outputs["embeddings"]
    flows = outputs["flows"]
    ref = next(iter(embs.values())) if embs else next(iter(flows.values()))["v"]
    total = at_least_f32(ref.new_zeros(()))
    metrics: Dict[str, torch.Tensor] = {}
    if w.contrastive > 0:
        ls = logit_scale if logit_scale is not None else torch.log(torch.tensor(
            1.0 / cfg.contrastive.temperature, dtype=torch.float32, device=ref.device))
        closs, cmetrics = multiway_clip_loss(embs, ls)
        total = total + w.contrastive * closs
        metrics.update(cmetrics)
    if w.flow > 0:
        for name, f in flows.items():
            loss = flow_matching_loss(f["v"], f["ut"])
            total = total + w.flow * loss
            metrics[f"flow_{name}"] = loss
    if w.regularization > 0:
        for name, f in flows.items():
            if "regularization" in f:
                total = total + w.regularization * f["regularization"]
                metrics[f"reg_{name}"] = f["regularization"]
    return total, metrics


def triple_flow_step_flops(cfg: Config, B: int, E: int) -> float:
    """Analytic matmul FLOPs (fwd+bwd ~= 3x fwd) of one triple_flow train
    step over B cells and E padded edges: every Dense whose output reaches
    the loss (2·rows·in·out), the three B x B similarities of the InfoNCE
    and the four B x B OT costs. The PiGNN's edge MLP is not counted: the
    edge state it updates feeds no node and no loss (JAX's jit drops it as
    dead code), so it is no work the model needs, although the port still
    runs its forward."""
    enc, fl = cfg.encoders, cfg.flow
    d, L = enc.latent_dim, enc.gnn.num_layers

    def mlp(rows, dims):
        return sum(2.0 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))

    cell = mlp(B, (enc.gene_dim, 2 * d, d)) + mlp(B, (1, enc.time_embed_dim, d))
    per_layer = (2.0 * B * d * d * 3 + 2.0 * E * d * d  # q/k/v on nodes, o_proj on edges
                 + mlp(B, (2 * d, 2 * d, d)) + 2.0 * d * d * 2)  # node MLP, gate per graph
    cell += L * per_layer + 2.0 * B * L * d * d + mlp(B, (2 * d, d, d))
    pert = (mlp(B, (enc.esm_dim, 2 * d, d)) + mlp(B, (enc.n_perturb_genes, d, d))
            + 4 * 2.0 * B * d * d + mlp(B, (2 * d, d, d)))
    prot = mlp(B, (enc.esm_dim,) + tuple(enc.protein_hidden_dims) + (d,))
    D = fl.latent_dim
    net = (mlp(B, (1, fl.time_embed_dim, D))
           + mlp(B, (3 * D if fl.use_time_embedding else 2 * D,)
                 + (fl.hidden_dim,) * fl.n_layers + (D,)))
    fwd = cell + pert + prot + 4 * (net + 2.0 * B * B * D) + 3 * 2.0 * B * B * d
    return 3.0 * fwd
