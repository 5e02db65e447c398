"""The port's batch embedding CLI (clip_dplm_tpu_torch/experiments/embed.py)
against the JAX package's (clip_dplm_tpu/experiments/embed.py): the same
FASTA / plain-text reader, and on the CPU the same embeddings from one
bundle (an ESM-2 tower, 2 layers, d=64, 4 heads) at a padded length in the
packed short-S band (S = 96) and past it (S = 264, the flash route), bf16 on
both sides (rtol 0.05 / atol 0.03)."""

import numpy as np
import pytest
import torch

from clip_dplm_tpu.experiments import embed as jax_embed
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.experiments import embed
from clip_dplm_tpu_torch.models.esm import ESMTower
from clip_dplm_tpu_torch.models.layers import init_params
from clip_dplm_tpu_torch.utils.pretrained import save_pretrained

BF16 = dict(rtol=0.05, atol=0.03)
FASTA = """>sp|P1|one first protein
MKTAYIAKQRQISFVKSHFSRQ
LEERLGLIEVQ
>two
MKV

>three desc
GGSUZOBXMK
"""


@pytest.mark.parametrize("text", [FASTA, "MKTAYIAK\n\nMKV\n  GGS  \n"])
def test_read_sequences_matches_jax(tmp_path, text):
    path = tmp_path / "in.txt"
    path.write_text(text)
    got = embed.read_sequences(str(path))
    assert got == jax_embed.read_sequences(str(path)) and len(got[1]) == 3


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("embed")
    cfg = pconfig.apply_overrides(pconfig.Config(), ["esm.d_model=64", "esm.num_layers=2",
                                                     "esm.num_heads=4"])
    tower = ESMTower(cfg.esm)
    init_params(tower, torch.Generator().manual_seed(0))
    save_pretrained(str(root / "bundle"), cfg, tower)
    rng = np.random.default_rng(0)
    with open(root / "seqs.fasta", "w") as f:
        for i, n in enumerate((30, 90, 250, 7, 400)):
            f.write(f">s{i}\n{''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'), n))}\n")
    return root


@pytest.mark.parametrize("max_len", [96, 264])
def test_embed_cli_matches_jax(inputs, tmp_path, max_len):
    args = ["--input", str(inputs / "seqs.fasta"), "--bundle", str(inputs / "bundle"),
            "--batch-size", "2", "--max-len", str(max_len)]
    got = embed.main(args + ["--output", str(tmp_path / "port.npz"), "--device", "cpu"])
    want = jax_embed.main(args + ["--output", str(tmp_path / "jax.npz")])
    assert list(got["names"]) == list(want["names"]) == [f"s{i}" for i in range(5)]
    assert got["embeddings"].shape == want["embeddings"].shape == (5, 64)
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], **BF16)
    with np.load(tmp_path / "port.npz") as z:
        np.testing.assert_array_equal(z["embeddings"], got["embeddings"])


def test_embed_cli_refusals(inputs, tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "o.npz")
    base = ["--input", str(inputs / "seqs.fasta"), "--output", out, "--device", "cpu"]
    with pytest.raises(SystemExit, match="queue 1 item 13"):
        embed.main(base + ["--pipeline-stages", "2"])
    empty = tmp_path / "empty.fa"
    empty.write_text("\n")
    with pytest.raises(SystemExit, match="no sequences"):
        embed.main(["--input", str(empty), "--output", out, "--device", "cpu"])
    got = embed.main(base + ["--max-len", "64", "--batch-size", "8"])
    assert got["embeddings"].shape == (5, 320) and "RANDOM" in capsys.readouterr().out
    assert embed.parse_args(["--input", "a", "--output", "b"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        embed.main(["--input", str(inputs / "seqs.fasta"), "--output", out])
