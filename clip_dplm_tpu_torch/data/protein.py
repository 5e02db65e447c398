"""Protein sequence tokenization over the public ESM-2 alphabet.

The same vocabulary, ids and padding rules as `clip_dplm_tpu/data/protein.py`
(fair-esm `proteinseq_toks` order, so ids line up with converted checkpoints),
in numpy only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

ESM_VOCAB: List[str] = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K",
    "Q", "N", "F", "Y", "M", "H", "W", "C",
    "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
TOKEN_TO_ID = {t: i for i, t in enumerate(ESM_VOCAB)}
CLS_IDX, PAD_IDX, EOS_IDX, UNK_IDX = 0, 1, 2, 3
MASK_IDX = TOKEN_TO_ID["<mask>"]
RESIDUES = "LAGVSERTIDPKQNFYMHWC"


def clean_sequence(seq: str, replace_uzob: bool = False) -> str:
    """Uppercase + whitespace strip; optionally map U/Z/O/B -> X."""
    seq = "".join(seq.split()).upper()
    if replace_uzob:
        seq = "".join("X" if c in "UZOB" else c for c in seq)
    return seq


def tokenize(
    seq: str,
    max_len: Optional[int] = None,
    add_special: bool = True,
    replace_uzob: bool = False,
) -> np.ndarray:
    """Sequence -> int32 ids [<cls>] + residues + [<eos>], truncated to
    max_len total."""
    seq = clean_sequence(seq, replace_uzob)
    ids = [TOKEN_TO_ID.get(c, UNK_IDX) for c in seq]
    if add_special:
        budget = None if max_len is None else max_len - 2
        ids = [CLS_IDX] + (ids if budget is None else ids[:budget]) + [EOS_IDX]
    elif max_len is not None:
        ids = ids[:max_len]
    return np.asarray(ids, dtype=np.int32)


def tokenize_batch(
    seqs: Sequence[str],
    max_len: Optional[int] = None,
    pad_multiple: int = 8,
    replace_uzob: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch tokenize + pad to a static shape: ((B, S) ids, (B, S) mask)."""
    toks = [tokenize(s, max_len, replace_uzob=replace_uzob) for s in seqs]
    L = max(len(t) for t in toks)
    S = ((L + pad_multiple - 1) // pad_multiple) * pad_multiple
    out = np.full((len(toks), S), PAD_IDX, dtype=np.int32)
    mask = np.zeros((len(toks), S), dtype=bool)
    for i, t in enumerate(toks):
        out[i, : len(t)] = t
        mask[i, : len(t)] = True
    return out, mask


def detokenize(ids: Sequence[int]) -> str:
    """Token ids -> residue string; drops cls/pad and stops at the first
    <eos> (the DPLM sampler emits [cls] residues [eos] [pad...])."""
    out = []
    for i in ids:
        i = int(i)
        if i == EOS_IDX:
            break
        if i in (CLS_IDX, PAD_IDX):
            continue
        tok = ESM_VOCAB[i] if 0 <= i < len(ESM_VOCAB) else "X"
        out.append(tok if len(tok) == 1 else "X")
    return "".join(out)


def random_protein(rng: np.random.Generator, length: int) -> str:
    """Synthetic sequence over the 20 standard residues (test fixture)."""
    return "".join(rng.choice(list(RESIDUES), size=length))
