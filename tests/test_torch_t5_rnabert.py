"""The port's ProtT5 and RNABERT encoders (clip_dplm_tpu_torch/models/t5.py,
models/rnabert.py), their tokenizers and HF converters, against the JAX
package on the same numpy weights, at a small size (ProtT5: 2 layers,
d_model 64, d_ff 128, 4 heads of 16; RNABERT: 2 layers at its published
width 120, 12 heads), padded batches:

- the towers in f32 (rtol 1e-4 / atol 1e-5), every pooling, and in bf16
  against JAX's bf16 (rtol 0.05 / atol 0.03);
- T5's relative position buckets equal JAX's, past max_distance too;
- JAX `export_*_torch_params` -> port `convert_*` gives JAX's outputs, and
  the port's `export_*` equals JAX's bit for bit;
- the ProtT5 and RNA tokenizers and the ProtT5 presets equal JAX's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.data import protein as jprotein
from clip_dplm_tpu.models import rnabert as jrnabert
from clip_dplm_tpu.models import t5 as jt5
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.data import protein
from clip_dplm_tpu_torch.models import rnabert, t5
from clip_dplm_tpu_torch.utils.convert import load_flax_params
from test_torch_esm import rng_params

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.03)
T5_SMALL = dict(d_model=64, d_ff=128, num_layers=2, num_heads=4, d_kv=16)
BERT_SMALL = dict(num_layers=2)
SEQS = ["MKTAYIAKQRQISFVKSHFSRQ", "MKV", "GGSUZOBX" * 5, "mk tay"]
RNA = ["ACGUACGUAGGCUA", "acgt tgca", "ACGNN" * 9, "U"]


def _cfgs(kind):
    if kind == "t5":
        return jconfig.ProtT5Config(**T5_SMALL), pconfig.ProtT5Config(**T5_SMALL)
    return jconfig.RNABertConfig(**BERT_SMALL), pconfig.RNABertConfig(**BERT_SMALL)


def _inputs(kind):
    if kind == "t5":
        return protein.tokenize_prot_t5_batch(SEQS)
    return rnabert.tokenize_rna_batch(RNA)


@functools.lru_cache(maxsize=None)
def _pair(kind, dtype="f32"):
    jcfg, pcfg = _cfgs(kind)
    jdt, pdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    toks, mask = _inputs(kind)
    if kind == "t5":
        jm, pm = jt5.ProtT5Tower(cfg=jcfg, dtype=jdt), t5.ProtT5Tower(pcfg, dtype=pdt)
    else:
        jm, pm = jrnabert.RNABertTower(cfg=jcfg, dtype=jdt), rnabert.RNABertTower(pcfg, dtype=pdt)
    params = rng_params(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(toks),
                                         jnp.asarray(mask))["params"], np.random.default_rng(1))
    return jcfg, pcfg, jm, params, load_flax_params(pm, params)


POOLINGS = {"t5": ("tokens", "mean_residues"), "bert": ("tokens", "mean")}


def _outputs(kind, jm, params, port, pooling):
    toks, mask = _inputs(kind)
    want = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(toks), jnp.asarray(mask),
                                      pooling=pooling))(params)
    with torch.no_grad():
        got = port(torch.from_numpy(toks), torch.from_numpy(mask), pooling=pooling)
    return got.float().numpy(), np.asarray(want, np.float32), mask


@pytest.mark.parametrize("kind,pooling", [(k, p) for k in POOLINGS for p in POOLINGS[k]])
def test_tower_matches_jax_f32(kind, pooling):
    _, _, jm, params, port = _pair(kind)
    got, want, _ = _outputs(kind, jm, params, port, pooling)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("kind", ["t5", "bert"])
def test_tower_matches_jax_bf16(kind):
    _, _, jm, params, port = _pair(kind, "bf16")
    got, want, _ = _outputs(kind, jm, params, port, POOLINGS[kind][1])
    np.testing.assert_allclose(got, want, **BF16)


def test_relative_position_buckets_match_jax():
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 3)[:, None]
    for nb, md in ((32, 128), (32, 16), (64, 256)):
        want = jt5.relative_position_bucket(jnp.asarray(rel), num_buckets=nb, max_distance=md)
        got = t5.relative_position_bucket(torch.from_numpy(rel), num_buckets=nb,
                                          max_distance=md)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_t5_traps():
    """Unscaled scores, one bias shared by every layer (owned at the top),
    an RMS norm without a mean or a bias, no bias in any projection."""
    port = _pair("t5")[-1]
    names = [k for k, _ in port.named_parameters()]
    assert "relative_attention_bias" in names
    assert not any("relative_attention_bias" in k for k in names if k.startswith("layer_"))
    assert not any(k.endswith(".bias") for k in names)
    x = torch.tensor([[3.0, 5.0]])
    ln = t5.T5LayerNorm(2, eps=0.0)
    np.testing.assert_allclose(ln(x).detach().numpy(),
                               (x / x.square().mean().sqrt()).numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind", ["t5", "bert"])
def test_convert_from_jax_export_gives_jax_outputs(kind):
    jcfg, pcfg, jm, params, _ = _pair(kind)
    export, convert = ((jt5.export_t5_torch_params, t5.convert_t5_torch_params) if kind == "t5"
                       else (jrnabert.export_bert_torch_params,
                             rnabert.convert_bert_torch_params))
    hf = {k: torch.from_numpy(v) for k, v in export(params, jcfg).items()}
    port = (t5.ProtT5Tower(pcfg, torch.float32) if kind == "t5"
            else rnabert.RNABertTower(pcfg, torch.float32))
    port.load_state_dict(convert(hf, pcfg), strict=True)
    got, want, _ = _outputs(kind, jm, params, port, POOLINGS[kind][1])
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("kind", ["t5", "bert"])
def test_export_equals_jax_bit_for_bit(kind):
    jcfg, pcfg, _, params, port = _pair(kind)
    if kind == "t5":
        got, want = t5.export_t5_torch_params(port, pcfg), jt5.export_t5_torch_params(params,
                                                                                       jcfg)
    else:
        got, want = (rnabert.export_bert_torch_params(port.state_dict(), pcfg),
                     jrnabert.export_bert_torch_params(params, jcfg))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k


def test_tokenizers_and_presets_match_jax():
    for seqs in (SEQS, ["A" * 40]):
        for max_len in (None, 12):
            g, w = protein.tokenize_prot_t5_batch(seqs, max_len), jprotein.tokenize_prot_t5_batch(
                seqs, max_len)
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
    assert protein.PROT_T5_VOCAB == jprotein.PROT_T5_VOCAB
    for max_len in (None, 9):
        g, w = rnabert.tokenize_rna_batch(RNA, max_len), jrnabert.tokenize_rna_batch(RNA, max_len)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    assert rnabert.tokenize_rna("acgt").tolist() == [4, 7, 6, 5]  # T read as U
    for name in ("prot_t5_xl", "prot_t5_base"):
        assert dataclasses.asdict(t5.prot_t5_config_from_name(name, num_layers=3)) == \
            dataclasses.asdict(jt5.prot_t5_config_from_name(name, num_layers=3))
    with pytest.raises(ValueError, match="preset"):
        t5.prot_t5_config_from_name("prot_t5_huge")
    for p, j in ((pconfig.ProtT5Config(), jconfig.ProtT5Config()),
                 (pconfig.RNABertConfig(), jconfig.RNABertConfig())):
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
