"""The port's dLLM sampler against the JAX package's, on the CPU.

Both samplers get the same deterministic logits: a numpy table indexed by
position and current token, so both frameworks read bit-equal float32
logits. At temperature 0 the picks must then be identical, step by step:
the timesteps are the same float32 numbers and both rankings are stable
sorts. At temperature > 0 the two draw different noise, so only the support
of the picks is checked.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import GenerationConfig as JGenCfg
from graphgpt_tpu.generation import dllm as jdllm
from graphgpt_torch.config import GenerationConfig
from graphgpt_torch.generation import dllm as tdllm

MASK = 1
B, T, V = 3, 48, 24


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(T, V)) * 2.0).astype(np.float32)
    tok = (rng.normal(size=(V, V)) * 2.0).astype(np.float32)
    tok[:, MASK] = -30.0  # the model rarely predicts the mask id
    return pos, tok


def _masked_ids(seed=1, ratio=(0.5, 0.7)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, V, size=(B, T)).astype(np.int32)
    ids[-1, T - 6 :] = 0  # pad cells stay as they are
    return tdllm.mask_at_ratio(ids, MASK, ratio, rng)


def _logits_fns(pos, tok):
    jpos, jtok = jnp.asarray(pos), jnp.asarray(tok)
    tpos, ttok = torch.from_numpy(pos), torch.from_numpy(tok)

    def jfn(x):
        return jpos[None] + jtok[x]

    def tfn(x):
        return tpos[None] + ttok[x.long()]

    return jfn, tfn


@pytest.mark.parametrize("eps", [1e-3, 0.05, 1e-4])
def test_timesteps_equal_jnp_linspace_bit_for_bit(eps):
    for steps in (1, 2, 8, 13, 64, 100, 255, 351):
        want = np.asarray(jnp.linspace(1.0, eps, steps + 1))
        got = tdllm.timesteps(steps, eps)
        assert got.dtype == np.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=str(steps))


@pytest.mark.parametrize("alg", ["maskgit_plus", "topk_margin", "entropy"])
@pytest.mark.parametrize("steps", [8, 64])
def test_sampler_picks_equal_jax_at_temperature_zero(alg, steps):
    pos, tok = _tables()
    jfn, tfn = _logits_fns(pos, tok)
    masked, _ = _masked_ids()
    jcfg = JGenCfg(steps=steps, alg=alg)
    tcfg = GenerationConfig(steps=steps, alg=alg)
    want = np.asarray(
        jdllm.make_unmask_sampler(jfn, jcfg, MASK)(jnp.asarray(masked), jax.random.PRNGKey(0))
    )
    sampler = tdllm.make_unmask_sampler(tfn, tcfg, MASK, device="cpu")
    got = sampler(torch.from_numpy(masked), None).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (got == MASK).any() and 0 < sampler.forwards <= steps
    np.testing.assert_array_equal(got[masked != MASK], masked[masked != MASK])


def test_sampler_loop_count_follows_the_while_loop():
    """No masked cell: no forward. Otherwise one forward a step, the last
    step filling whatever is left."""
    pos, tok = _tables(seed=2)
    _, tfn = _logits_fns(pos, tok)
    masked, mask = _masked_ids(seed=3, ratio=(0.1, 0.2))
    calls = []

    def counting(x):
        calls.append(1)
        return tfn(x)

    ids = torch.from_numpy(np.where(mask, 5, masked))
    sampler = tdllm.make_unmask_sampler(counting, GenerationConfig(steps=8), MASK, device="cpu")
    assert torch.equal(sampler(ids), ids) and sampler.forwards == len(calls) == 0
    out = sampler(torch.from_numpy(masked))
    assert sampler.forwards == len(calls) == 8 and not (out == MASK).any()
    sampler = tdllm.make_unmask_sampler(tfn, GenerationConfig(steps=1), MASK, device="cpu")
    out = sampler(torch.from_numpy(masked))
    assert sampler.forwards == 1 and not (out == MASK).any()


@pytest.mark.parametrize("alg", ["maskgit_plus", "entropy"])
def test_sample_per_example_matches_jax(alg):
    pos, tok = _tables(seed=4)
    jfn, tfn = _logits_fns(pos, tok)
    masked, _ = _masked_ids(seed=5)
    x = masked[0]
    want, jh = jdllm.sample_per_example(
        jfn, JGenCfg(alg=alg), MASK, jnp.asarray(x), jax.random.PRNGKey(0), output_history=True
    )
    got, th = tdllm.sample_per_example(
        tfn, GenerationConfig(alg=alg), MASK, torch.from_numpy(x), None,
        output_history=True, device="cpu",
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(th) == len(jh)
    for a, b in zip(th, jh):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got2, none = tdllm.sample_per_example(
        tfn, GenerationConfig(alg=alg), MASK, torch.from_numpy(x), None, device="cpu"
    )
    assert none is None
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want))


def test_sample_tokens_and_filters_match_jax():
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(4, 10, V)) * 2).astype(np.float32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    for kw in (dict(), dict(margin_confidence=True), dict(neg_entropy=True),
               dict(top_k=5), dict(top_p=0.8)):
        jc, jx = jdllm.sample_tokens(jl, None, **kw)
        tc, tx = tdllm.sample_tokens(tl, None, **kw)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=1e-5)
    for p in (0.3, 0.9):
        np.testing.assert_array_equal(
            np.isinf(tdllm.top_p_filter(tl, p).numpy()), np.isinf(np.asarray(jdllm.top_p_filter(jl, p)))
        )
    np.testing.assert_array_equal(
        tdllm.top_k_filter(tl, 4).numpy(), np.asarray(jdllm.top_k_filter(jl, 4))
    )


@pytest.mark.parametrize("kw", [dict(top_k=3), dict(top_p=0.5)], ids=["top-k", "top-p"])
def test_sampling_with_temperature_stays_in_the_support(kw):
    rng = np.random.default_rng(7)
    logits = torch.from_numpy((rng.normal(size=(8, 32, V)) * 2).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    _, x0 = tdllm.sample_tokens(logits, gen, temperature=0.7, **kw)
    scaled = logits / 0.7
    if "top_k" in kw:
        support = torch.isfinite(tdllm.top_k_filter(scaled, kw["top_k"]))
    else:
        support = torch.isfinite(tdllm.top_p_filter(scaled, kw["top_p"]))
    assert support.gather(-1, x0.long()[..., None]).all()
    # the whole sampler at temperature > 0 keeps its picks in the support too
    pos, tok = _tables(seed=8)
    _, tfn = _logits_fns(pos, tok)
    masked, mask = _masked_ids(seed=9)
    cfg = dataclasses.replace(GenerationConfig(steps=6, temperature=0.7), **kw)
    out = tdllm.make_unmask_sampler(tfn, cfg, MASK, device="cpu")(
        torch.from_numpy(masked), torch.Generator().manual_seed(1)
    )
    assert not (out == MASK).any()
    assert (out[torch.from_numpy(~mask)] == torch.from_numpy(masked[~mask])).all()


def test_mask_at_ratio_and_accuracy_match_jax():
    ids = np.random.default_rng(10).integers(0, V, size=(B, T)).astype(np.int32)
    jm, jmask = jdllm.mask_at_ratio(ids, MASK, (0.3, 0.4), np.random.default_rng(11))
    tm, tmask = tdllm.mask_at_ratio(ids, MASK, (0.3, 0.4), np.random.default_rng(11))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tmask, jmask)
    assert not tmask[ids == 0].any()
    gen = np.where(tmask, (ids + (np.arange(T) % 3 == 0)) % V, ids).astype(np.int32)
    want = jdllm.generation_accuracy(jnp.asarray(gen), jnp.asarray(ids), jnp.asarray(tmask))
    got = tdllm.generation_accuracy(
        torch.from_numpy(gen), torch.from_numpy(ids), torch.from_numpy(tmask)
    )
    assert got["n_masked"].item() == int(want["n_masked"])
    assert abs(got["acc"].item() - float(want["acc"])) < 1e-7


def test_sampler_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdllm.make_unmask_sampler(lambda x: x, GenerationConfig(), MASK)
