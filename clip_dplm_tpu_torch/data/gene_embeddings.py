"""Gene/protein -> embedding pipeline for the triple_flow data.

Counterpart of `clip_dplm_tpu/data/gene_embeddings.py`:
`fetch_uniprot_sequence` (the canonical reviewed sequence of a gene from
UniProt's REST service, gated on `requests` and the network: no test calls
it), the hash-keyed `EmbeddingCache` with `.npz` persistence,
`build_gene_embedding_dict` (gene -> pooled embedding over any embed_fn,
over-length sequences skipped, cached ones not embedded again), and the
embed functions over the port's towers: `make_esm_embed_fn` (ESMTower,
mean over the residues), `make_prot_t5_embed_fn` (ProtT5Tower, mean over
the residues) and `make_rnabert_embed_fn` (RNABertTower, per-base tokens or
their mean). An embed function tokenizes on the host, runs the tower on its
own device without gradients and returns numpy f32.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

MAX_SEQUENCE_AA = 10_000  # proteins longer than this are skipped (tf nb cell 21)


def fetch_uniprot_sequence(
    gene: str, organism_id: int = 9606, timeout: float = 10.0
) -> Optional[str]:
    """Canonical reviewed sequence for a gene symbol via UniProt REST.
    Returns None on miss or over-length; raises ImportError without network
    tooling (gated — zero egress in this image)."""
    try:
        import requests  # gated
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "UniProt fetch needs `requests` + network; supply a gene->sequence "
            "dict to build_gene_embedding_dict instead"
        ) from e
    url = (
        "https://rest.uniprot.org/uniprotkb/search?query="
        f"gene_exact:{gene}+AND+organism_id:{organism_id}+AND+reviewed:true"
        "&format=json&fields=sequence&size=1"
    )
    try:
        r = requests.get(url, timeout=timeout)
        r.raise_for_status()
        results = r.json().get("results", [])
        if not results:
            return None
        seq = results[0]["sequence"]["value"]
        return None if len(seq) > MAX_SEQUENCE_AA else seq
    except Exception:
        return None  # skip failures, as the reference does


class EmbeddingCache:
    """Hash-keyed sequence -> embedding cache with optional disk persistence
    (triple_flow/3_esm_integration.py:103-106 semantics)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: Dict[str, np.ndarray] = {}
        if path and os.path.exists(path):
            z = np.load(path)
            self._mem = {k: z[k] for k in z.files}

    @staticmethod
    def key(seq: str) -> str:
        return hashlib.sha1(seq.encode()).hexdigest()

    def get(self, seq: str) -> Optional[np.ndarray]:
        return self._mem.get(self.key(seq))

    def put(self, seq: str, emb: np.ndarray) -> None:
        self._mem[self.key(seq)] = np.asarray(emb, np.float32)

    def save(self) -> None:
        if self.path:
            np.savez_compressed(self.path, **self._mem)


def build_gene_embedding_dict(
    gene_to_seq: Dict[str, str],
    embed_fn: Callable[[Iterable[str]], np.ndarray],
    batch_size: int = 32,
    cache: Optional[EmbeddingCache] = None,
    max_len_aa: int = MAX_SEQUENCE_AA,
) -> Dict[str, np.ndarray]:
    """gene -> pooled embedding dict.

    embed_fn maps a list of sequences to (B, d) pooled embeddings — e.g. an
    ESMTower with mean_residues pooling bound to converted 650M weights
    (models/esm.py). Over-length sequences are skipped; cached sequences are
    not re-embedded.
    """
    out: Dict[str, np.ndarray] = {}
    pending_genes, pending_seqs = [], []

    def flush():
        if not pending_seqs:
            return
        embs = np.asarray(embed_fn(list(pending_seqs)), np.float32)
        for g, s, e in zip(pending_genes, pending_seqs, embs):
            out[g] = e
            if cache is not None:
                cache.put(s, e)
        pending_genes.clear()
        pending_seqs.clear()

    for gene, seq in gene_to_seq.items():
        if seq is None or len(seq) > max_len_aa:
            continue
        if cache is not None:
            hit = cache.get(seq)
            if hit is not None:
                out[gene] = hit
                continue
        pending_genes.append(gene)
        pending_seqs.append(seq)
        if len(pending_seqs) >= batch_size:
            flush()
    flush()
    if cache is not None:
        cache.save()
    return out


def _embed_fn(tower, tokenize, pooling: str):
    def embed(seqs):
        toks, mask = tokenize(list(seqs))
        device = next(tower.parameters()).device
        with torch.no_grad():
            out = tower(torch.as_tensor(toks, device=device),
                        torch.as_tensor(mask, device=device), pooling=pooling)
        return out.float().cpu().numpy()

    return embed


def make_esm_embed_fn(esm_tower, max_len: int = 1024):
    """An ESMTower (models/esm.py) as an embed_fn for
    build_gene_embedding_dict: tokenize, then the mean over the residues."""
    from clip_dplm_tpu_torch.data.protein import tokenize_batch

    return _embed_fn(esm_tower, lambda seqs: tokenize_batch(seqs, max_len=max_len),
                     "mean_residues")


def make_prot_t5_embed_fn(t5_tower, max_len: int = 1024):
    """A ProtT5Tower (models/t5.py) as an embed_fn: UZOB -> X tokenization,
    then the mean over the residues."""
    from clip_dplm_tpu_torch.data.protein import tokenize_prot_t5_batch

    return _embed_fn(t5_tower, lambda seqs: tokenize_prot_t5_batch(seqs, max_len=max_len),
                     "mean_residues")


def make_rnabert_embed_fn(rnabert_tower, max_len: int = 440, pooling: str = "tokens"):
    """An RNABertTower (models/rnabert.py) as an embedding fn for RNA
    motifs: pooling="tokens" gives (B, S, 120) per-base embeddings, "mean"
    one vector a sequence."""
    from clip_dplm_tpu_torch.models.rnabert import tokenize_rna_batch

    return _embed_fn(rnabert_tower, lambda seqs: tokenize_rna_batch(seqs, max_len=max_len),
                     pooling)
