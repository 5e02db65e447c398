"""Experiment registry: config.experiment -> (model, data source).

Counterpart of `clip_dplm_tpu/experiments/registry.py`: `two_tower`,
`rna_rbp`, `esm_clip`, `tf_clip`, `triple_flow` and `dplm`; every other
name raises.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from clip_dplm_tpu_torch.config import Config
from clip_dplm_tpu_torch.data.collate import TokenPairDataset
from clip_dplm_tpu_torch.data.synthetic import PairedEmbeddingDataset

EXPERIMENTS = ("two_tower", "rna_rbp", "esm_clip", "tf_clip", "triple_flow", "dplm")
KNN_ROWS = 16  # rows of the (B, B) kNN distances computed at once


def _require_ported(cfg: Config) -> None:
    if cfg.experiment not in EXPERIMENTS:
        raise ValueError(f"experiment {cfg.experiment!r} is not ported; the port has "
                         f"{', '.join(EXPERIMENTS)}")


def build_model(cfg: Config, device=None, dtype: Optional[torch.dtype] = None):
    """The experiment's model on `device` (the caller's choice). `dtype` is
    the compute dtype (bf16 when None) of every family but triple_flow,
    which is built in f32 whatever is asked, as the JAX package builds it
    (its yaml's compute_dtype is applied by nothing there either)."""
    _require_ported(cfg)
    if cfg.experiment == "triple_flow":
        from clip_dplm_tpu_torch.models.triple_flow_model import TripleFlowModel

        return TripleFlowModel(cfg, device=device)
    dtype = torch.bfloat16 if dtype is None else dtype
    if cfg.experiment == "dplm":
        from clip_dplm_tpu_torch.models.dplm import DPLM

        return DPLM(cfg.dplm, dtype=dtype, device=device)
    if cfg.experiment == "rna_rbp":
        from clip_dplm_tpu_torch.models.token_towers import RNARBPCLIP

        return RNARBPCLIP(cfg, dtype=dtype, device=device)
    if cfg.experiment == "esm_clip":
        from clip_dplm_tpu_torch.models.protein_clip import ESMProteinCLIP

        return ESMProteinCLIP(cfg, dtype=dtype, device=device)
    if cfg.experiment == "tf_clip":
        from clip_dplm_tpu_torch.models.tf_clip import TFContrastiveModel

        return TFContrastiveModel(cfg, dtype=dtype, device=device)
    from clip_dplm_tpu_torch.models.clip import TwoTowerCLIP

    return TwoTowerCLIP(cfg, dtype=dtype, device=device)


def build_data(cfg: Config, split_seed: int = 0):
    """(train_batches_fn, val_batches_fn): callables yielding fresh iterators
    of numpy batches. two_tower: {"a", "b"}; `dataset=synthetic` is the
    2048-pair fixture of the reference, `dataset=embeddings` loads an .npz
    with `a` and `b` from data.path; 85/15 split. rna_rbp: {"rna_tokens",
    "rna_mask", "rbp_tokens", "rbp_mask"} from 1024 synthetic token-sequence
    pairs, the first 85 % for training, padded to 64 / 128 tokens. esm_clip:
    `_esm_clip_data`. tf_clip: `_tf_clip_data`. triple_flow:
    `_triple_flow_data`. dplm: `_dplm_data`. The ragged tail is dropped."""
    _require_ported(cfg)
    B = cfg.train.batch_size
    if cfg.experiment == "esm_clip":
        return _esm_clip_data(cfg, split_seed)
    if cfg.experiment == "tf_clip":
        return _tf_clip_data(cfg, split_seed)
    if cfg.experiment == "triple_flow":
        return _triple_flow_data(cfg, split_seed)
    if cfg.experiment == "dplm":
        return _dplm_data(cfg, split_seed)
    if cfg.experiment == "rna_rbp":
        ds = TokenPairDataset.synthetic(1024, dim_a=cfg.rna_tower.input_dim,
                                        dim_b=cfg.rbp_tower.input_dim, seed=split_seed)
        cut = int(len(ds) * 0.85)
        train = TokenPairDataset(ds.seqs_a[:cut], ds.seqs_b[:cut])
        val = TokenPairDataset(ds.seqs_a[cut:], ds.seqs_b[cut:])
        pa, pb = 64, 128
        return (lambda seed=0: train.batches(B, seed=seed, pad_to_a=pa, pad_to_b=pb),
                lambda: val.batches(B, shuffle=False, pad_to_a=pa, pad_to_b=pb))
    d = cfg.data
    if d.dataset == "embeddings":
        if not d.path:
            raise ValueError("dataset=embeddings needs data.path")
        z = np.load(d.path)
        ds = PairedEmbeddingDataset(a=z["a"].astype(np.float32), b=z["b"].astype(np.float32),
                                    labels=z["labels"] if "labels" in z else None,
                                    gaussian_noise=d.augment.gaussian_noise)
    elif d.dataset == "synthetic":
        ds = PairedEmbeddingDataset.synthetic(
            2048, cfg.tower_a.input_dim, cfg.tower_b.input_dim, n_classes=8, seed=split_seed)
    else:
        raise ValueError(f"unknown dataset {d.dataset!r}")
    train, val = ds.split(0.85, seed=split_seed)

    def strip(b):
        return {k: v for k, v in b.items() if k != "labels"}

    return (lambda seed=0: (strip(b) for b in train.batches(B, seed=seed)),
            lambda: (strip(b) for b in val.batches(B, shuffle=False)))


def _batch_iter(arrays: Dict[str, np.ndarray], batch_size: int, seed, shuffle=True):
    n = len(next(iter(arrays.values())))
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    for s in range(0, n - batch_size + 1, batch_size):
        sel = order[s:s + batch_size]
        yield {k: v[sel] for k, v in arrays.items()}


def _split(arrays: Dict[str, np.ndarray], frac: float = 0.85):
    cut = int(len(next(iter(arrays.values()))) * frac)
    return ({k: v[:cut] for k, v in arrays.items()}, {k: v[cut:] for k, v in arrays.items()})


def _esm_clip_data(cfg: Config, seed: int):
    """The reference's synthetic RNA-token <-> protein-sequence pairs with
    class structure: 32 classes, each with a fixed residue sequence of
    S = min(64, esm.max_len) tokens (<cls>, residues, <eos>, <pad>) and an
    RNA token prototype (32 tokens of rna_tower.input_dim); 1024 samples
    drawn over the classes, RNA rows with 0.3 noise; the first 85 % for
    training. numpy draws in the reference's order."""
    from clip_dplm_tpu_torch.models.dplm import CLS_IDX, EOS_IDX, PAD_IDX

    rng = np.random.default_rng(seed)
    n, n_classes = 1024, 32
    S_rna, S_prot = 32, min(64, cfg.esm.max_len)
    rna_dim = cfg.rna_tower.input_dim
    prot_class = np.full((n_classes, S_prot), PAD_IDX, np.int32)
    lens = rng.integers(S_prot // 2, S_prot - 2, n_classes)
    for c in range(n_classes):
        prot_class[c, 0] = CLS_IDX
        prot_class[c, 1:1 + lens[c]] = rng.integers(4, 24, lens[c])
        prot_class[c, 1 + lens[c]] = EOS_IDX
    rna_proto = rng.normal(size=(n_classes, S_rna, rna_dim)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    arrays = {
        "rna_tokens": (rna_proto[labels]
                       + 0.3 * rng.normal(size=(n, S_rna, rna_dim))).astype(np.float32),
        "rna_mask": np.ones((n, S_rna), bool),
        "protein_tokens": prot_class[labels],
    }
    arrays["protein_mask"] = arrays["protein_tokens"] != PAD_IDX
    train, val = _split(arrays)
    B = cfg.train.batch_size
    return (lambda seed=0: _batch_iter(train, B, seed),
            lambda: _batch_iter(val, B, 0, shuffle=False))


def knn_connectivity(x: np.ndarray, k: int = 8) -> np.ndarray:
    """Symmetric kNN graph of the rows of x, (B, B) f32 with a zero
    diagonal: j is a neighbour of i when |x_i - x_j|^2 is at most i's
    (k+1)-th smallest (itself included). The distances are computed
    KNN_ROWS rows at a time, each as the reference's ((x_i - x_j)**2).sum(-1)
    so the graph is the reference's bit for bit, without its (B, B, dim)
    intermediate."""
    n = len(x)
    kk = min(k, n - 1)
    conn = np.empty((n, n), np.float32)
    for i0 in range(0, n, KNN_ROWS):
        d2 = ((x[i0:i0 + KNN_ROWS, None] - x[None, :]) ** 2).sum(-1)
        kth = np.partition(d2, kk, axis=1)[:, kk]
        conn[i0:i0 + KNN_ROWS] = d2 <= kth[:, None]
    np.fill_diagonal(conn, 0.0)
    return np.maximum(conn, conn.T)


def _tf_clip_data(cfg: Config, seed: int):
    """The reference's synthetic 3-way TF data: 1024 samples whose cell
    state, top-DEG perturbation tokens and TF protein embedding share a
    16-d latent; an 85/15 split; each batch's dense connectivity is the kNN
    graph of its cells."""
    enc = cfg.encoders
    rng = np.random.default_rng(seed)
    n, k, T = 1024, 16, enc.n_perturb_genes
    z = rng.normal(size=(n, k)).astype(np.float32)
    w_cell = rng.normal(size=(k, enc.gene_dim + 1)).astype(np.float32) / np.sqrt(k)
    w_esm = rng.normal(size=(k, T * enc.esm_dim)).astype(np.float32) / np.sqrt(k)
    w_prot = rng.normal(size=(k, enc.esm_dim)).astype(np.float32) / np.sqrt(k)

    def noise(*s):
        return 0.1 * rng.normal(size=s).astype(np.float32)

    arrays = {
        "cell_state": z @ w_cell + noise(n, enc.gene_dim + 1),
        "gene_esm": (z @ w_esm).reshape(n, T, enc.esm_dim) + noise(n, T, enc.esm_dim),
        "gene_values": rng.uniform(-1, 1, (n, T)).astype(np.float32),
        "protein_emb": z @ w_prot + noise(n, enc.esm_dim),
    }
    train, val = _split(arrays)
    B = cfg.train.batch_size

    def with_connectivity(it):
        for b in it:
            b["connectivity"] = knn_connectivity(b["cell_state"])
            yield b

    return (lambda seed=0: with_connectivity(_batch_iter(train, B, seed)),
            lambda: with_connectivity(_batch_iter(val, B, 0, shuffle=False)))


def _triple_flow_data(cfg: Config, seed: int):
    """The reference's synthetic cells through the host pipeline
    (data/cells.py, data/multimodal.py): 1024 trajectory-structured cells of
    encoders.gene_dim genes -> kNN graph, diffusion pseudotime and leiden
    clusters -> TripleFlowDataset subgraph batches (the perturbation's
    top-DEG ESM from a random gene -> esm_dim table, a random protein
    embedding per cell), augmented in training; the first 85 % of the cells
    for training. numpy draws in the reference's order."""
    from clip_dplm_tpu_torch.data.multimodal import DataAugmentation, get_dataloader

    enc = cfg.encoders
    train_ds, val_ds = _triple_flow_sets(enc.gene_dim, enc.esm_dim, enc.n_perturb_genes, seed)
    aug = DataAugmentation(cfg.data.augment, seed=seed)
    B = cfg.train.batch_size
    return (lambda seed=0: get_dataloader(train_ds, B, augment=aug, seed=seed),
            lambda: get_dataloader(val_ds, B, shuffle=False))


@functools.lru_cache(maxsize=2)
def _triple_flow_sets(gene_dim: int, esm_dim: int, n_perturb_genes: int, seed: int):
    """The (train, val) TripleFlowDatasets of `_triple_flow_data`: a function
    of the widths and the seed only, which nothing mutates, so a process
    builds them once (the graph statistics take seconds at 2000 genes)."""
    from clip_dplm_tpu_torch.data.cells import CellData
    from clip_dplm_tpu_torch.data.multimodal import TripleFlowDataset

    rng = np.random.default_rng(seed)
    n = 1024
    cells = CellData.synthetic(n_cells=n, n_genes=gene_dim, seed=seed)
    gene_to_esm = {g: rng.normal(size=esm_dim).astype(np.float32) for g in range(gene_dim)}
    prot = rng.normal(size=(n, esm_dim)).astype(np.float32)
    cut = int(n * 0.85)

    def subset(ids):
        return TripleFlowDataset(
            CellData(X=cells.X[ids], obs={k: v[ids] for k, v in cells.obs.items()},
                     layers={k: v[ids] for k, v in cells.layers.items()}),
            gene_to_esm=gene_to_esm, protein_embeddings=prot[ids],
            n_top_degs=n_perturb_genes)

    return subset(np.arange(cut)), subset(np.arange(cut, n))


def motif_proteins(rng, n: int, S: int) -> np.ndarray:
    """(n, S) int32 token rows: <cls>, a residue sequence tiled from one of
    24 random 8-residue motifs (learnable local structure), <eos>, then
    <pad>; lengths in [S/2, S-2). numpy draws in this order: the motifs, the
    lengths, then each row's motif."""
    from clip_dplm_tpu_torch.models.dplm import CLS_IDX, EOS_IDX, PAD_IDX

    n_motifs, motif_len = 24, 8
    motifs = rng.integers(4, 24, (n_motifs, motif_len))
    tokens = np.full((n, S), PAD_IDX, np.int32)
    lens = rng.integers(S // 2, S - 2, n)
    for i in range(n):
        seq = np.tile(motifs[rng.integers(n_motifs)], S // motif_len + 1)[: lens[i]]
        tokens[i, 0] = CLS_IDX
        tokens[i, 1: 1 + lens[i]] = seq
        tokens[i, 1 + lens[i]] = EOS_IDX
    return tokens


def _dplm_data(cfg: Config, seed: int):
    """The reference's synthetic protein corpus for the diffusion denoiser:
    1024 motif-tiled rows of S = min(64, dplm.max_len) tokens
    (`motif_proteins`, the reference's draws), {"tokens", "mask"} batches,
    the first 85 % for training."""
    from clip_dplm_tpu_torch.models.dplm import PAD_IDX

    tokens = motif_proteins(np.random.default_rng(seed), 1024, min(64, cfg.dplm.max_len))
    arrays = {"tokens": tokens, "mask": tokens != PAD_IDX}
    train, val = _split(arrays)
    B = cfg.train.batch_size
    return (lambda seed=0: _batch_iter(train, B, seed),
            lambda: _batch_iter(val, B, 0, shuffle=False))
