"""Llama-semantics backbone for inference.

Counterpart of `graphgpt_tpu/models/modeling.py` (`_rms_norm_ref` :94,
`embed_inputs` :298, `backbone_apply` :360, `model_hidden_states` :618),
eval only: no dropout, DropPath or remat. Parameters are fp32 master
copies under HF-Llama names; activations run in `cfg.dtype`. Attention goes
through `ops.attention` (the flash kernel); the MLP through the norm-fused
kernel unless the model has LayerScale, which raises on a CUDA tensor (its
split kernel is a later slice's) and runs the plain split path on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.attention import attention
from ..ops.mlp import fused_norm_mlp, mlp_ref
from .rope import reset_position_ids, rope_cos_sin


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF-Llama RMSNorm: fp32 statistics and scaling, cast back."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


def _linear(device, d_in, d_out):
    return nn.utils.skip_init(nn.Linear, d_in, d_out, bias=False, device=device)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, hkv, dh = (
            cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        )
        self.q_proj = _linear(device, d, h * dh)
        self.k_proj = _linear(device, d, hkv * dh)
        self.v_proj = _linear(device, d, hkv * dh)
        self.o_proj = _linear(device, h * dh, d)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _linear(device, d, i)
        self.up_proj = _linear(device, d, i)
        self.down_proj = _linear(device, i, d)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.hidden_size
        self.input_layernorm = RMSNorm(d, device)
        self.self_attn = Attention(cfg, device)
        self.post_attention_layernorm = RMSNorm(d, device)
        self.mlp = MLP(cfg, device)
        if cfg.layer_scale_init_value > 0:
            self.lambda_1 = nn.Parameter(
                torch.full((d,), cfg.layer_scale_init_value, device=device)
            )
            self.lambda_2 = nn.Parameter(
                torch.full((d,), cfg.layer_scale_init_value, device=device)
            )

    def forward(self, x, cfg: ModelConfig, b, p, segment_ids, rope):
        """x: [B*P, D] in the compute dtype."""
        dt = x.dtype
        h, hkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        at = self.self_attn
        hpre = rms_norm(x, self.input_layernorm.weight, cfg.rms_norm_eps)
        q = F.linear(hpre, at.q_proj.weight.to(dt)).view(b, p, h, dh)
        k = F.linear(hpre, at.k_proj.weight.to(dt)).view(b, p, hkv, dh)
        v = F.linear(hpre, at.v_proj.weight.to(dt)).view(b, p, hkv, dh)
        a = attention(
            q, k, v, segment_ids, causal=cfg.causal_attention,
            bi_causal_split=cfg.bi_causal_split, attn_block=cfg.attn_block, rope=rope,
        )
        a = F.linear(a.reshape(b * p, h * dh), at.o_proj.weight.to(dt))
        use_ls = hasattr(self, "lambda_1")
        if use_ls:
            a = a * self.lambda_1.to(dt)
        x = x + a
        m = self.mlp
        if not use_ls:
            return fused_norm_mlp(
                x, self.post_attention_layernorm.weight, m.gate_proj.weight,
                m.up_proj.weight, m.down_proj.weight, cfg.rms_norm_eps, cfg.hidden_act,
            )
        if x.is_cuda:
            raise NotImplementedError(
                "LayerScale models take the split MLP kernel (_mlp_kernel), which "
                "a later slice ports"
            )
        # LayerScale on a CPU tensor: the plain split path (the twin of xla_mlp)
        hpre = rms_norm(x, self.post_attention_layernorm.weight, cfg.rms_norm_eps)
        out = mlp_ref(hpre, m.gate_proj.weight, m.up_proj.weight, m.down_proj.weight,
                      cfg.hidden_act)
        if use_ls:
            out = out * self.lambda_2.to(dt)
        return x + out


def embed_inputs(
    embed_weight: torch.Tensor,  # [V, D]
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, P] or [B, P, F]
    stacked_agg_w: Optional[torch.Tensor] = None,  # [F, D] (gated aggregation)
) -> torch.Tensor:
    """Stacked-feature embedding: gather-sum (or gated sum) over F, and the
    `long` stack method's 1/#nonzero scaling."""
    dt = compute_dtype(cfg)
    table = embed_weight.to(dt)
    ids = input_ids.long()
    if ids.dim() == 3 and cfg.stacked_feat_agg_method != "gated":
        emb = table[ids[..., 0]]
        for f in range(1, ids.shape[-1]):
            emb = emb + table[ids[..., f]]
    else:
        emb = table[ids]
        if ids.dim() == 3:
            w = stacked_agg_w.to(dt).float()
            emb = torch.einsum("bsfd,fd->bsd", emb.float(), w).to(dt)
    if ids.dim() == 3 and cfg.stack_method == "long":
        nonzero = (ids != 0).sum(dim=-1, keepdim=True).float() + 1e-7
        emb = emb * (1.0 / nonzero.to(dt)).clamp(max=1.0)
    return emb


class Backbone(nn.Module):
    """Embedding table, decoder layers and final norm (HF `model.*`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.utils.skip_init(
            nn.Embedding, cfg.vocab_size, cfg.hidden_size, device=device
        )
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.num_hidden_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, device)

    def forward(self, inputs_embeds, position_ids, segment_ids):
        """[B, P, D] embeddings -> final-normed hidden states [B, P, D]."""
        cfg = self.cfg
        x = inputs_embeds.to(compute_dtype(cfg))
        b, p, d = x.shape
        pos = reset_position_ids(position_ids, cfg.rope_range)
        rope = rope_cos_sin(
            pos, cfg.head_dim, cfg.rope_theta, resonance=cfg.rope_resonance,
            dtype=torch.float32, rope_scaling=cfg.rope_scaling,
            max_position_embeddings=cfg.max_position_embeddings,
        )
        x = x.reshape(b * p, d)
        for layer in self.layers:
            x = layer(x, cfg, b, p, segment_ids, rope)
        return rms_norm(x, self.norm.weight, cfg.rms_norm_eps).view(b, p, d)


def model_hidden_states(
    backbone: Backbone,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    position_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    stacked_agg_w: Optional[torch.Tensor] = None,
    raw_embeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Input embedding -> decoder -> final norm."""
    if raw_embeds is not None and cfg.embed_dim > 0:
        raise NotImplementedError(
            "the raw-embedding branch (embed_dim > 0) waits for a later slice"
        )
    x = embed_inputs(backbone.embed_tokens.weight, cfg, input_ids, stacked_agg_w)
    return backbone(x, position_ids, segment_ids)
