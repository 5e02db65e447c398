"""Port's ESM-2 block and tower (clip_dplm_tpu_torch/models/esm.py) against
the flax modules on the same numpy weights and inputs, in f32, at S = 10, 70
and 260 so that all three attention regimes of the port's dispatch run
(plain, packed short-S, flash), with both flax param layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu.config import ESMConfig as JaxESMConfig
from clip_dplm_tpu.models import esm as jax_esm
from clip_dplm_tpu_torch.config import ESMConfig
from clip_dplm_tpu_torch.models import esm
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params

# f32 on both sides; the bound covers summation order only
TOL = dict(atol=1e-4, rtol=1e-4)
POOLINGS = ("tokens", "mean_residues", "cls")


def rng_params(tree, rng):
    """Replace every leaf of a flax param tree with numpy draws."""
    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _tokens(rng, B, S, with_mask_tokens=True):
    lens = rng.integers(max(3, S // 2), S + 1, B)
    lens[0] = S
    toks = np.full((B, S), 1, np.int32)
    for i, L in enumerate(lens):
        toks[i, 0], toks[i, L - 1] = 0, 2
        toks[i, 1:L - 1] = rng.integers(4, 24, L - 2)
        if with_mask_tokens:
            toks[i, 1 + rng.integers(0, L - 2, max(1, L // 8))] = 32
    return toks, toks != 1


@pytest.mark.parametrize("S", [10, 70, 260])
def test_esm_block_matches_flax(rng, S):
    B, D, H = 2, 64, 2
    blk = jax_esm.EsmBlock(d_model=D, num_heads=H, dtype=jnp.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    _, mask = _tokens(rng, B, S)
    pos = np.arange(S)
    params = rng_params(
        blk.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                 jnp.asarray(pos))["params"], rng)
    want = blk.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                     jnp.asarray(pos))
    port = esm.EsmBlock(D, H)
    port.load_state_dict(flax_to_state_dict(params, 0))
    got = port(torch.from_numpy(x), torch.from_numpy(mask), torch.arange(S))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("S", [10, 70, 260])
def test_esm_tower_matches_flax(rng, S, scan_layers):
    """Token dropout on (inputs carry <mask> tokens), all three poolings."""
    B = 3
    jcfg = JaxESMConfig(d_model=64, num_layers=2, num_heads=2,
                        scan_layers=scan_layers)
    tower = jax_esm.ESMTower(cfg=jcfg, dtype=jnp.float32)
    toks, mask = _tokens(rng, B, S)
    params = rng_params(tower.init(jax.random.PRNGKey(0), jnp.asarray(toks[:, :8]),
                                   jnp.asarray(mask[:, :8]))["params"], rng)
    want = jax.jit(lambda p, t, m: tuple(
        tower.apply({"params": p}, t, m, pooling=pl) for pl in POOLINGS))(
            params, jnp.asarray(toks), jnp.asarray(mask))
    port = load_flax_params(
        esm.ESMTower(ESMConfig(d_model=64, num_layers=2, num_heads=2),
                     dtype=torch.float32), params)
    with torch.no_grad():
        for pooling, w in zip(POOLINGS, want):
            got = port(torch.from_numpy(toks), torch.from_numpy(mask),
                       pooling=pooling)
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL,
                                       err_msg=pooling)


def test_stack_unstack_match_flax_layout(rng):
    jcfg = JaxESMConfig(d_model=32, num_layers=3, num_heads=2)
    tower = jax_esm.ESMTower(cfg=jcfg, dtype=jnp.float32)
    params = rng_params(tower.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8), jnp.int32))["params"], rng)
    want = jax.tree_util.tree_map(np.asarray, jax_esm.stack_esm_layers(params, 3))
    got = esm.stack_esm_layers(jax.tree_util.tree_map(np.asarray, params), 3)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    back = esm.unstack_esm_layers(got, 3)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, params))):
        np.testing.assert_array_equal(a, b)


def test_config_and_sizes_match_reference():
    assert esm.ESM2_SIZES == jax_esm.ESM2_SIZES
    for name in esm.ESM2_SIZES:
        got = esm.esm_config_from_name(name, max_len=512)
        want = jax_esm.esm_config_from_name(name, max_len=512)
        # the port keeps the fields it reads, each with the reference's value
        assert got.__dict__ == {k: want.__dict__[k] for k in got.__dict__}


def test_rotary_embed_matches_flax(rng):
    x = rng.normal(size=(2, 3, 12, 16)).astype(np.float32)
    pos = np.arange(12)
    want = jax_esm.rotary_embed(jnp.asarray(x), jnp.asarray(pos))
    got = esm.rotary_embed(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    xb = x.transpose(0, 2, 1, 3).reshape(2, 12, 48)
    want_b = jax_esm.rotary_embed_bsd(jnp.asarray(xb), jnp.asarray(pos), 3)
    got_b = esm.rotary_embed_bsd(torch.from_numpy(xb), torch.from_numpy(pos), 3)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-6)
