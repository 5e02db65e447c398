"""Port's DPLM trunk and sampler (clip_dplm_tpu_torch/models/dplm.py) against
the flax model on the same numpy weights: logits in f32 at S = 10, 70 and
260 with both param layouts, the one-step greedy sample token for token, and
the sampler's invariants over several steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu.config import DPLMConfig as JaxDPLMConfig
from clip_dplm_tpu.models import dplm as jax_dplm
from clip_dplm_tpu_torch.config import DPLMConfig
from clip_dplm_tpu_torch.models import dplm
from clip_dplm_tpu_torch.utils.convert import load_flax_params
from test_torch_esm import rng_params

TOL = dict(atol=1e-4, rtol=1e-4)  # f32 on both sides: summation order only


def _pair(rng, scan_layers=False, steps=4):
    kw = dict(d_model=64, num_layers=2, num_heads=2, max_len=300,
              num_diffusion_steps=steps)
    model = jax_dplm.DPLM(cfg=JaxDPLMConfig(scan_layers=scan_layers, **kw),
                          dtype=jnp.float32)
    params = rng_params(model.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8), jnp.int32))["params"], rng)
    port = load_flax_params(dplm.DPLM(DPLMConfig(**kw), dtype=torch.float32),
                            params)
    return model, params, port


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("S", [10, 70, 260])
def test_logits_match_flax(rng, S, scan_layers):
    model, params, port = _pair(rng, scan_layers)
    B = 2
    toks = rng.integers(4, 24, (B, S)).astype(np.int32)
    toks[:, 0] = 0
    toks[1, S // 2:] = 1  # ragged second row
    toks[1, S // 2 - 1] = 2
    toks[0, 1::5] = 32
    want = model.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = port(torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_one_step_greedy_sample_matches_flax(rng):
    """num_steps=1, temperature=0: the proposal is the argmax over residues
    (the Gumbel draw cannot move it), so tokens agree exactly."""
    model, params, port = _pair(rng)
    lengths = np.array([60, 7, 33], np.int32)
    want_t, want_c = jax_dplm.sample(
        model, params, jax.random.PRNGKey(1), batch_size=3, length=64,
        num_steps=1, temperature=0.0, lengths=jnp.asarray(lengths))
    got_t, got_c = dplm.sample(
        port, torch.Generator().manual_seed(1), batch_size=3, length=64,
        num_steps=1, temperature=0.0, lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    want_c = np.asarray(want_c)
    finite = np.isfinite(want_c)
    np.testing.assert_array_equal(np.isfinite(got_c.numpy()), finite)
    np.testing.assert_allclose(got_c.numpy()[finite], want_c[finite],
                               atol=1e-4, rtol=1e-4)


def test_multi_step_invariants(rng):
    _, _, port = _pair(rng, steps=5)
    lengths = [3, 50, 8, 12]  # 50 > length: clamped to it
    toks, conf = dplm.sample(port, torch.Generator().manual_seed(3),
                             batch_size=4, length=12,
                             lengths=torch.tensor(lengths))
    toks, conf = toks.numpy(), conf.numpy()
    assert toks.shape == conf.shape == (4, 14)
    for i, L in enumerate(min(L, 12) for L in lengths):
        assert toks[i, 0] == dplm.CLS_IDX
        assert toks[i, L + 1] == dplm.EOS_IDX
        inner = toks[i, 1:L + 1]
        assert ((inner >= dplm.RESIDUE_LO) & (inner <= dplm.RESIDUE_HI)).all()
        assert (toks[i, L + 2:] == dplm.PAD_IDX).all()
        assert np.isfinite(conf[i, 1:L + 1]).all()
    assert not (toks == dplm.MASK_IDX).any()
    # uniform lengths == the default full-length path, same generator seed
    full, _ = dplm.sample(port, torch.Generator().manual_seed(4), 2, 6)
    via, _ = dplm.sample(port, torch.Generator().manual_seed(4), 2, 6,
                         lengths=torch.tensor([6, 6]))
    np.testing.assert_array_equal(full.numpy(), via.numpy())


def test_sample_rejects_bad_lengths_shape(rng):
    _, _, port = _pair(rng)
    with pytest.raises(ValueError, match="lengths"):
        dplm.sample(port, torch.Generator(), batch_size=3, length=8,
                    lengths=torch.tensor([3, 8]))


def test_config_defaults_match_reference():
    got, want = DPLMConfig(), JaxDPLMConfig()
    assert got.__dict__ == {k: want.__dict__[k] for k in got.__dict__}


@pytest.mark.parametrize("num_steps", [1, 7, 100])
def test_cosine_keep_schedule_matches_flax(num_steps):
    steps = np.arange(num_steps, dtype=np.float32)
    want = np.asarray(jax_dplm._cosine_keep_schedule(jnp.asarray(steps), num_steps))
    got = np.array([dplm._cosine_keep_schedule(s, num_steps) for s in range(num_steps)])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
