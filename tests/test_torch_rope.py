"""The port's RoPE tables against the JAX package's, on the CPU.

`scaled_inv_freq` is the same float64 numpy code in both, so its tables are
equal; cos/sin are computed in float32 by two frameworks, so they agree to
float32 rounding of the phase (atol 2e-6 at positions below 1024).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models import rope as jrope
from graphgpt_torch.models import rope as trope

SCALINGS = [
    None,
    {"rope_type": "linear", "factor": 2.0},
    {"rope_type": "dynamic", "factor": 2.0, "seq_len": 2048},
    {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 256},
    {"rope_type": "yarn", "factor": 2.0, "mscale": 1.3, "beta_fast": 16.0},
    {"type": "llama3", "factor": 8.0, "original_max_position_embeddings": 256},
]


def _pos(b=2, p=96, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 1024, size=(b, p)), axis=-1).astype(np.int32)


@pytest.mark.parametrize("scaling", SCALINGS)
@pytest.mark.parametrize("resonance", [False, True])
def test_rope_cos_sin_matches_jax(scaling, resonance):
    pos = _pos()
    kw = dict(resonance=resonance, rope_scaling=scaling, max_position_embeddings=1024)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 64, 10000.0, **kw)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 64, 10000.0, **kw)
    assert tc.shape == (2, 96, 64) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6, rtol=0)


@pytest.mark.parametrize("scaling", SCALINGS[1:])
def test_scaled_inv_freq_is_the_same_table(scaling):
    want = jrope.scaled_inv_freq(32, 10000.0, scaling, 512)
    got = trope.scaled_inv_freq(32, 10000.0, scaling, 512)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_unknown_scaling_raises():
    with pytest.raises(ValueError):
        trope.scaled_inv_freq(64, 1e4, {"rope_type": "ntk-by-parts"}, 1024)


@pytest.mark.parametrize("rope_range", [0, 64])
def test_reset_position_ids_matches_jax(rope_range):
    pos = _pos(seed=1)
    want = np.asarray(jrope.reset_position_ids(jnp.asarray(pos), rope_range, 1024))
    got = trope.reset_position_ids(torch.from_numpy(pos), rope_range).numpy()
    np.testing.assert_array_equal(got, want)
    if rope_range:
        assert got.dtype == np.float32 and got.max() < rope_range


def test_apply_rope_and_rotate_half_match_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 96, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, 96, 2, 64)).astype(np.float32)
    cos, sin = jrope.rope_cos_sin(jnp.asarray(_pos()), 64)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), cos, sin)
    t = torch.from_numpy
    tq, tk = trope.apply_rope(t(q), t(k), t(np.asarray(cos)), t(np.asarray(sin)))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
    np.testing.assert_array_equal(
        trope.rotate_half(t(q)).numpy(), np.asarray(jrope.rotate_half(jnp.asarray(q)))
    )


def test_rope_cos_sin_float_positions():
    """rope_range positions are fractional; both frameworks take them as
    float32 phases."""
    pos = _pos(seed=3)
    jpos = jrope.reset_position_ids(jnp.asarray(pos), 50, 1024)
    tpos = trope.reset_position_ids(torch.from_numpy(pos), 50)
    jc, _ = jrope.rope_cos_sin(jpos, 64)
    tc, _ = trope.rope_cos_sin(tpos, 64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6, rtol=0)
