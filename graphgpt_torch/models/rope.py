"""Rotary position embeddings (HF-Llama rotate_half convention).

Counterpart of `graphgpt_tpu/models/rope.py`: theta 1e4, Resonance RoPE,
the HF `rope_scaling` types, the reference's `rope_range` rescaling, and
`rope_3d_cos_sin` (:172) and `step_pos_emb` (:198), which no model of
either package calls yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def scaled_inv_freq(
    head_dim: int,
    theta: float,
    rope_scaling: Optional[dict],
    max_position_embeddings: int,
) -> Tuple[np.ndarray, float]:
    """(inv_freq [Dh/2], attention_factor) per HF modeling_rope_utils, in
    float64 numpy (all inputs are static)."""
    exponent = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    if not rope_scaling:
        return inv_freq, 1.0
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
    factor = float(rope_scaling.get("factor", 1.0))
    if rope_type == "default":
        return inv_freq, 1.0
    if rope_type == "linear":
        return inv_freq / factor, 1.0
    if rope_type == "dynamic":
        seq_len = max(int(rope_scaling.get("seq_len") or 0), max_position_embeddings)
        base = theta * (
            (factor * seq_len / max_position_embeddings) - (factor - 1)
        ) ** (head_dim / (head_dim - 2))
        return 1.0 / (base**exponent), 1.0
    if rope_type == "yarn":
        orig = int(
            rope_scaling.get("original_max_position_embeddings", max_position_embeddings)
        )
        beta_fast = float(rope_scaling.get("beta_fast") or 32.0)
        beta_slow = float(rope_scaling.get("beta_slow") or 1.0)
        attention_factor = rope_scaling.get("attention_factor")
        if attention_factor is None:
            mscale = rope_scaling.get("mscale")
            attention_factor = (
                0.1 * math.log(factor) + 1.0 if mscale is None else float(mscale)
            )

        def find_correction_dim(num_rotations):
            return (head_dim * math.log(orig / (num_rotations * 2 * math.pi))) / (
                2 * math.log(theta)
            )

        low = max(math.floor(find_correction_dim(beta_fast)), 0)
        high = min(math.ceil(find_correction_dim(beta_slow)), head_dim - 1)
        denom = max(high - low, 1e-3)
        ramp = np.clip((np.arange(head_dim // 2, dtype=np.float64) - low) / denom, 0, 1)
        extrapolation = 1.0 - ramp
        out = (inv_freq / factor) * (1 - extrapolation) + inv_freq * extrapolation
        return out, float(attention_factor)
    if rope_type == "llama3":
        orig = int(
            rope_scaling.get("original_max_position_embeddings", max_position_embeddings)
        )
        low_ff = float(rope_scaling.get("low_freq_factor", 1.0))
        high_ff = float(rope_scaling.get("high_freq_factor", 4.0))
        low_freq_wavelen = orig / low_ff
        high_freq_wavelen = orig / high_ff
        wavelen = 2 * math.pi / inv_freq
        out = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
        smooth = (orig / wavelen - low_ff) / (high_ff - low_ff)
        smoothed = (1 - smooth) * out / factor + smooth * out
        is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
        return np.where(is_medium, smoothed, out), 1.0
    raise ValueError(f"unsupported rope_scaling type {rope_type!r}")


def rope_cos_sin(
    position_ids: torch.Tensor,  # [B, P]
    head_dim: int,
    theta: float = 10000.0,
    resonance: bool = False,
    dtype: torch.dtype = torch.float32,
    rope_scaling: Optional[dict] = None,
    max_position_embeddings: int = 1024,
):
    """(cos, sin), each [B, P, head_dim] with the halves duplicated."""
    inv_freq_np, attention_factor = scaled_inv_freq(
        head_dim, theta, rope_scaling, max_position_embeddings
    )
    inv_freq = torch.as_tensor(
        inv_freq_np.astype(np.float32), device=position_ids.device
    )
    if resonance:
        # round each wavelength to an integer (float32, as the JAX package)
        two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=inv_freq.device)
        inv_freq = two_pi / torch.round(two_pi / inv_freq)
    freqs = position_ids.to(torch.float32)[..., None] * inv_freq[None, None, :]
    # the float32 phases, their cos and sin in float64, rounded once: on the
    # CPU the first float32 cos of a fresh process came back ~1e-4 off on
    # one thread's chunk of 2048 entries in ~2% of processes (not with one
    # thread); float64 stays inside a float32 ulp whatever path a thread takes
    emb = torch.cat([freqs, freqs], dim=-1).double()
    cos = torch.cos(emb) * attention_factor
    sin = torch.sin(emb) * attention_factor
    return cos.to(dtype), sin.to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: [B, P, H, Dh]; cos, sin: [B, P, Dh]. Rotates in q's dtype."""
    cos = cos.to(q.dtype)[:, :, None, :]
    sin = sin.to(q.dtype)[:, :, None, :]
    q2 = q * cos + rotate_half(q) * sin
    k2 = k * cos + rotate_half(k) * sin
    return q2, k2.to(k.dtype)


def reset_position_ids(position_ids: torch.Tensor, rope_range: int):
    """Rescale positions into [0, rope_range): pos * rope_range / (row max + 1),
    float; the identity when rope_range <= 0."""
    if rope_range <= 0:
        return position_ids
    pos = position_ids.to(torch.float32)
    row_max = pos.amax(dim=-1, keepdim=True) + 1.0
    return pos * (float(rope_range) / row_max)


def rope_3d_cos_sin(
    position_ids_3d: torch.Tensor,  # [B, P, 3] discretised x, y, z coordinates
    head_dim: int,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
):
    """3D rotary embedding (reference RotaryEmbedding3D,
    utils_graphgpt.py:465-550): exponents from -Dh/2 to Dh/2, so that the
    frequencies span theta^(1/2)..theta^(-1/2), and the Dh/2 frequency slots
    take the axes in turn (x, y, z, x, ...). (cos, sin), each [B, P, Dh],
    the phases in float32 as the JAX package has them, their cos and sin in
    float64 (see rope_cos_sin), rounded once."""
    start = -(head_dim // 2)
    exponent = np.arange(start, start + head_dim, 2, dtype=np.float64) / head_dim
    freq = torch.as_tensor((1.0 / (theta**exponent)).astype(np.float32),
                           device=position_ids_3d.device)
    expand_rate = int(np.ceil((head_dim // 2) / 3.0))
    b, p, _ = position_ids_3d.shape
    pos = position_ids_3d.to(torch.float32)[:, :, None, :].expand(b, p, expand_rate, 3)
    pos = pos.reshape(b, p, expand_rate * 3)[:, :, : head_dim // 2]
    emb = torch.cat([pos * freq, pos * freq], dim=-1).double()
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def step_pos_emb(dim: int, mpe: int) -> np.ndarray:
    """The additive sinusoidal step-position table (reference
    get_step_pos_emb, utils_graphgpt.py:553-571): integer periods 1..dim/2,
    angular frequency 2 pi / period, columns (cos_0, sin_0, cos_1, ...);
    [mpe, dim] float32."""
    periods = np.arange(1, dim // 2 + 1, dtype=np.float64)
    ang = np.arange(mpe, dtype=np.float64)[:, None] * (2.0 * np.pi / periods)[None, :]
    out = np.empty((mpe, dim), dtype=np.float32)
    out[:, 0::2] = np.cos(ang)
    out[:, 1::2] = np.sin(ang)
    return out
