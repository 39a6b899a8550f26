"""The port's flash attention against the JAX package's, on the CPU.

The JAX kernel runs in the Pallas interpreter (GGT_PALLAS_INTERPRET=1);
the port runs the kernel's plain version (CPU tensors). fp32 throughout,
tolerance 2e-5: the two differ only in the order of fp32 sums. The CUDA
kernel is held against its plain version in tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models.rope import apply_rope as j_apply_rope
from graphgpt_tpu.models.rope import rope_cos_sin as j_rope_cos_sin
from graphgpt_tpu.ops import flash_attention as jfa
from graphgpt_tpu.ops.attention import attention as j_attention
from graphgpt_tpu.ops.attention import xla_attention
from graphgpt_torch.models.rope import apply_rope, rope_cos_sin
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops.attention import attention, attention_ref
from graphgpt_torch.synthetic import packed_segments

TOL = 2e-5


def _inputs(b=2, p=128, h=2, hkv=2, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, p, h, dh)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(b, p, hkv, dh)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(b, p, hkv, dh)) * 0.5).astype(np.float32)
    seg = packed_segments(b, p, rng)
    seg[-1, p - 24 :] = 0  # padded tail
    pos = np.tile(np.arange(p, dtype=np.int32), (b, 1))
    return q, k, v, seg, pos


def _rope_np(pos, dh):
    cos, sin = j_rope_cos_sin(jnp.asarray(pos), dh)
    return np.asarray(cos), np.asarray(sin)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_interpreted_kernel(causal, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    q, k, v, seg, pos = _inputs()
    cos, sin = _rope_np(pos, 64)
    qs, kf, vf, dh = jfa._prep(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None)
    bq, bk = jfa._fwd_blocks(q.shape[1])
    want_out, want_lse = jfa._flash_fwd(
        qs, kf, vf, jnp.asarray(seg), jnp.asarray(seg), causal, bq, bk, 2, dh,
        rope=(jnp.asarray(cos), jnp.asarray(sin)),
    )
    t = torch.from_numpy
    out, lse = tfa.flash_attention(
        t(q), t(k), t(v), t(seg), causal=causal, rope=(t(cos), t(sin)), return_lse=True
    )
    want_out = np.asarray(want_out).reshape(out.shape)
    np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TOL, rtol=TOL)
    assert np.all(lse.numpy()[-1, :, -24:] == -1e30)
    assert np.all(out.numpy()[-1, -24:] == 0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_xla_attention(causal):
    q, k, v, seg, pos = _inputs(seed=1)
    cos, sin = _rope_np(pos, 64)
    jq, jk = j_apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cos), jnp.asarray(sin))
    want = np.asarray(xla_attention(jq, jk, jnp.asarray(v), jnp.asarray(seg), causal))
    t = torch.from_numpy
    got = tfa.flash_attention(t(q), t(k), t(v), t(seg), causal=causal, rope=(t(cos), t(sin)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    tq, tk = apply_rope(t(q), t(k), t(cos), t(sin))
    ref = attention_ref(tq, tk, t(v), t(seg), causal)
    np.testing.assert_allclose(ref.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bi_split", [0, 16])
def test_attention_dispatch_gqa_and_windows(bi_split):
    """GQA repeat, attn_block windows and the bi-causal mask of the port's
    dispatcher against the JAX dispatcher's XLA path."""
    q, k, v, seg, pos = _inputs(h=4, hkv=2, seed=2)
    seg = packed_segments(2, 128, np.random.default_rng(3), block=64)
    cos, sin = _rope_np(pos, 64)
    block = 0 if bi_split else 64
    want = np.asarray(
        j_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg), impl="xla",
            bi_causal_split=bi_split, attn_block=block,
            rope=(jnp.asarray(cos), jnp.asarray(sin)),
        )
    )
    t = torch.from_numpy
    got = attention(
        t(q), t(k), t(v), t(seg), bi_causal_split=bi_split, attn_block=block,
        rope=(t(cos), t(sin)),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_rope_cos_sin_feeds_the_same_tables():
    _, _, _, _, pos = _inputs()
    cos, sin = rope_cos_sin(torch.from_numpy(pos), 64)
    jcos, jsin = _rope_np(pos, 64)
    np.testing.assert_allclose(cos.numpy(), jcos, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), jsin, atol=1e-6)


def test_bf16_rotation_is_apply_rope():
    """The kernel's rotation (each product and the sum rounded to bf16) is
    exactly apply_rope in bf16, and within one bf16 rounding of JAX's."""
    q, k, _, _, pos = _inputs(seed=4)
    cos, sin = _rope_np(pos, 64)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    b, p, h, dh = q.shape
    rq = tfa.rotate_tokens(t(q).reshape(b, p, h * dh), t(cos), t(sin), dh)
    aq, _ = apply_rope(t(q), t(k), t(cos), t(sin))
    assert torch.equal(rq.view(b, p, h, dh), aq)
    jq, _ = j_apply_rope(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(cos), jnp.asarray(sin),
    )
    np.testing.assert_allclose(
        aq.float().numpy(), np.asarray(jq, np.float32), atol=2e-2, rtol=1e-2
    )


def test_cpu_wrapper_runs_the_plain_version():
    q, k, v, seg, pos = _inputs()
    t = torch.from_numpy
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(
        t(q).reshape(2, 128, 128), t(k).reshape(2, 128, 128), t(v).reshape(2, 128, 128),
        t(seg), None, None, False, 64,
    )
    assert tfa.flash_fwd.launches == before
    assert out.shape == (2, 128, 128) and lse.shape == (2, 2, 128)
