"""Llama-semantics backbone, for inference and training.

Counterpart of `graphgpt_tpu/models/modeling.py` (`_rms_norm_vjp` :101,
`_dropout` :175, `_embed_lookup_sum` :240, `embed_inputs` :298,
`add_raw_embeds` :332, `backbone_apply` :360 with its rematerialisation
:545-612, `model_hidden_states` :618). Parameters are fp32 master copies under
HF-Llama names; activations run in `cfg.dtype`. Attention goes through
`ops.attention` (the flash kernels), its pre-norm and q/k/v products
through `rms_norm` and three products, or, under `GGT_ATTN_NORM_FUSE=1`
(read on each call, as the JAX package reads it on each trace, :418), the
norm-fused q/k/v kernel; the MLP through the norm-fused kernel,
or, when LayerScale or DropPath sit between the MLP and the residual,
through the RMSNorm and the split MLP kernel; under MLP dropout through the
plain `xla_mlp`, as the JAX package's dispatch (:478-521) does.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..config import ModelConfig
from ..ops import mm_f32
from ..ops.attention import attention
from ..ops.mlp import fused_mlp, fused_norm_mlp, fused_norm_qkv, rmsnorm_bwd, xla_mlp
from .rope import reset_position_ids, rope_cos_sin


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class _RMSNorm(torch.autograd.Function):
    """`_rms_norm_vjp`: the forward of `_rms_norm_vjp_fwd`; the backward is
    the rmsnorm_bwd kernel on a CUDA tensor and its plain version elsewhere.
    Saves x and the weight (the backward computes the statistics again)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        x32 = x.float()
        rrms = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return (x32 * rrms * weight.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        d = x.shape[-1]
        dx, dw = rmsnorm_bwd(x.reshape(-1, d), g.reshape(-1, d), weight, ctx.eps)
        return dx.view(x.shape), dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF-Llama RMSNorm: fp32 statistics and scaling, cast back; its
    gradient goes through the rmsnorm_bwd kernel."""
    return _RMSNorm.apply(x, weight, eps)


def _dropout(x, rate: float, gen: Optional[torch.Generator], train: bool):
    """Inverted dropout with masks drawn from `gen`."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _drop_path(x, rate: float, gen: Optional[torch.Generator], train: bool):
    """Per-sample stochastic depth on x [B, ...]."""
    if not train or gen is None:
        return x
    keep_prob = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = torch.rand(shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0).to(x.dtype)


def derive_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator that depends only on (seed, index), as `fold_in` does: a
    layer's masks are the same in the first pass and in the recompute."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1000003 + (index + 2) * 7919) % (2**63 - 1))
    return gen


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

    def attn_half(self, x, cfg: ModelConfig, b, p, segment_ids, rope, gen=None,
                  dp_rate: float = 0.0, train: bool = False, stash=None):
        """x + attention(norm(x)) for x [B*P, D] in the compute dtype."""
        dt = x.dtype
        h, hkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        at = self.self_attn
        if os.environ.get("GGT_ATTN_NORM_FUSE", "0") == "1":
            q, k, v = fused_norm_qkv(x, self.input_layernorm.weight, at.q_proj.weight,
                                     at.k_proj.weight, at.v_proj.weight, cfg.rms_norm_eps)
        else:
            hpre = rms_norm(x, self.input_layernorm.weight, cfg.rms_norm_eps)
            q, k, v = (F.linear(hpre, w.to(dt)) for w in (at.q_proj.weight, at.k_proj.weight,
                                                          at.v_proj.weight))
        q, k, v = q.view(b, p, h, dh), k.view(b, p, hkv, dh), v.view(b, p, hkv, dh)
        a = attention(
            q, k, v, segment_ids, causal=cfg.causal_attention,
            bi_causal_split=cfg.bi_causal_split, attn_block=cfg.attn_block, rope=rope,
            stash=stash,
        )
        a = F.linear(a.reshape(b * p, h * dh), at.o_proj.weight.to(dt))
        a = _dropout(a, cfg.attention_dropout, gen, train)
        if hasattr(self, "lambda_1"):
            a = a * self.lambda_1.to(dt)
        if train and gen is not None and cfg.path_dropout > 0:
            a = _drop_path(a.view(b, p, -1), dp_rate, gen, train).view(b * p, -1)
        return x + a

    def mlp_half(self, x, cfg: ModelConfig, b, p, gen=None, dp_rate: float = 0.0,
                 train: bool = False):
        """x + mlp(norm(x)): the norm-fused kernel; with LayerScale or
        DropPath between the MLP and the residual, the RMSNorm and the split
        MLP kernel; with MLP dropout, the plain `xla_mlp`."""
        dt = x.dtype
        m = self.mlp
        use_ls = hasattr(self, "lambda_1")
        use_dp = train and gen is not None and cfg.path_dropout > 0
        use_mdrop = train and gen is not None and cfg.mlp_dropout > 0
        weights = (m.gate_proj.weight, m.up_proj.weight, m.down_proj.weight)
        if not (use_ls or use_dp or use_mdrop):
            return fused_norm_mlp(
                x, self.post_attention_layernorm.weight, *weights, cfg.rms_norm_eps,
                cfg.hidden_act,
            )
        hpre = rms_norm(x, self.post_attention_layernorm.weight, cfg.rms_norm_eps)
        if use_mdrop:
            out = _dropout(xla_mlp(hpre, *weights, cfg.hidden_act), cfg.mlp_dropout, gen, train)
        else:
            out = fused_mlp(hpre, *weights, cfg.hidden_act)
        if use_ls:
            out = out * self.lambda_2.to(dt)
        if use_dp:
            out = _drop_path(out.view(b, p, -1), dp_rate, gen, train).view(b * p, -1)
        return x + out

    def forward(self, x, cfg: ModelConfig, b, p, segment_ids, rope):
        """x: [B*P, D] in the compute dtype (eval)."""
        return self.mlp_half(self.attn_half(x, cfg, b, p, segment_ids, rope), cfg, b, p)


def _count_matrix_grad(flat_ids, gf, vocab: int, chunk: int):
    """sum_n onehots(flat_ids[n])^T gf[n] as fp32 [vocab, D]: per chunk of
    rows a count matrix [chunk, vocab] (counts <= F, exact in bf16) times
    the cotangent, summed in fp32. No atomics touch the result, so it is the
    same from run to run."""
    n, d = gf.shape
    acc = torch.zeros((vocab, d), dtype=torch.float32, device=gf.device)
    for c0 in range(0, n, chunk):
        ids = flat_ids[c0 : c0 + chunk]
        counts = torch.zeros((ids.shape[0], vocab), dtype=gf.dtype, device=gf.device)
        counts.scatter_add_(1, ids, torch.ones(ids.shape, dtype=gf.dtype, device=gf.device))
        acc += mm_f32(counts.t(), gf[c0 : c0 + chunk])
    return acc


# The embedding gradient's route: the count-matrix product costs ~2.7e-9 ms
# a (row, vocab) pair, the sorted segment sum ~1.77 ms plus ~5.1e-6 ms an
# id (NVIDIA H100 80GB HBM3, 700 W: chip_smoke.py's phases A and B time both
# at N 28,672 x F 3 and N 995,328 x F 1 over V 1,024-576,906). So the count
# matrix while V <= SEGMENT_FIXED / N + SEGMENT_PER_ID * F: V 28.9k at
# phase A's shape, 2.5k at phase B's, ~61k for a graph-level fine-tune batch.
SEGMENT_FIXED = 6.6e8
SEGMENT_PER_ID = 1870
SEGMENT_BLOCK = 128  # sorted slots a block of the segment sum sums at once
SEGMENT_CHUNK = 1 << 17  # sorted slots gathered at once


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, summed and returned in fp32 (bf16 operands keep their
    fp32 sums; fp32 operands are not rounded to TF32)."""
    if not a.is_cuda:
        return a.float() @ b.float()
    if a.dtype == torch.float32:
        with _no_tf32():
            return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


def _block_run_sums(keys, vals, shift: int = 0):
    """One level of the segment sum: `keys` [M] sorted dense run indices,
    `vals` [M, D]; per block of SEGMENT_BLOCK slots the sum of each of its
    runs (a 0/1 matrix times the block, in fp32): (their keys, sums fp32).
    `shift` zero rows in front of the first run move every block boundary
    by that many slots."""
    blk, d = SEGMENT_BLOCK, vals.shape[1]
    if shift:  # zero rows in the first run change no sum
        keys = torch.cat([keys[:1].expand(shift), keys])
        vals = torch.cat([vals.new_zeros((shift, d)), vals])
    pad = (-keys.shape[0]) % blk
    if pad:  # zero rows in the last run change no sum
        keys = torch.cat([keys, keys[-1:].expand(pad)])
        vals = torch.cat([vals, vals.new_zeros((pad, d))])
    kb = keys.view(-1, blk)
    first = kb[:, :1]
    local = kb - first  # < blk: dense run indices grow by at most 1 a slot
    slots = torch.arange(blk, device=keys.device)
    onehot = (local[:, None, :] == slots[None, :, None]).to(vals.dtype)
    sums = _bmm_f32(onehot, vals.view(-1, blk, d))  # [blocks, run in block, D]
    keep = slots[None, :] <= local[:, -1:]
    return (first + slots)[keep], sums[keep]


def _segment_sum_grad(ids, gf, vocab: int):
    """The same gradient as `_count_matrix_grad` for ids [N, F] and gf
    [N, D] (each id of row n takes gf[n]), as a sorted segment sum: the
    flat ids stably sorted, each run of equal ids summed in a fixed order
    by levels of `_block_run_sums` until one row a run is left, each row of
    the table written once. No atomics, no [rows, vocab] matrix. Every
    other level moves the block boundaries by half a block: a level that
    leaves no two rows of one run in a block (a run's last rows split
    across a boundary) is followed by one that merges each such pair."""
    n, f = ids.shape
    d = gf.shape[1]
    out = torch.zeros((vocab, d), dtype=torch.float32, device=gf.device)
    if ids.numel() == 0:
        return out
    sorted_ids, perm = torch.sort(ids.reshape(-1), stable=True)
    uniq, counts = torch.unique_consecutive(sorted_ids, return_counts=True)
    runs = torch.repeat_interleave(torch.arange(len(uniq), device=ids.device), counts)
    keys, sums = [], []
    for c0 in range(0, len(runs), SEGMENT_CHUNK):
        k, v = _block_run_sums(runs[c0 : c0 + SEGMENT_CHUNK],
                               gf[perm[c0 : c0 + SEGMENT_CHUNK] // f])
        keys.append(k)
        sums.append(v)
    keys, sums = torch.cat(keys), torch.cat(sums)
    level = 1
    while len(keys) > len(uniq):
        keys, sums = _block_run_sums(keys, sums, level % 2 * (SEGMENT_BLOCK // 2))
        level += 1
    out[uniq] = sums
    return out


def segment_route(n: int, f: int, vocab: int) -> bool:
    """Whether the embedding gradient of n rows of f ids over `vocab` takes
    the sorted segment sum (else the count-matrix product)."""
    return vocab > SEGMENT_FIXED / max(n, 1) + SEGMENT_PER_ID * f


def embedding_grad(ids, gf, vocab: int, chunk: int):
    """sum over (n, f) of onehot(ids[n, f]) gf[n] as fp32 [vocab, D]: the
    count-matrix product (`chunk` rows at a time) or, where `segment_route`
    says, the sorted segment sum. Both are the same from run to run."""
    if segment_route(*ids.shape, vocab):
        return _segment_sum_grad(ids, gf, vocab)
    return _count_matrix_grad(ids, gf, vocab, chunk)


class _EmbedLookup(torch.autograd.Function):
    """table[ids] with the backward of `_embed_lookup_bwd` (`embedding_grad`)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d = g.shape[-1]
        dtab = embedding_grad(ids.reshape(-1, 1), g.reshape(-1, d), ctx.vocab, 65536)
        return dtab.to(g.dtype), None


class _EmbedLookupSum(torch.autograd.Function):
    """sum_f table[ids[..., f]] without a [B, P, F, D] tensor on either side;
    the backward is `_embed_lookup_sum_bwd`'s (`embedding_grad`), summed in
    fp32."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        out = table[ids[..., 0]]
        for f in range(1, ids.shape[-1]):
            out = out + table[ids[..., f]]
        return out

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d = g.shape[-1]
        dtab = embedding_grad(ids.reshape(-1, ids.shape[-1]), g.reshape(-1, d), ctx.vocab, 8192)
        return dtab.to(g.dtype), None


def embed_inputs(
    embed_weight: torch.Tensor,  # [V, D]
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, P] or [B, P, F]
    stacked_agg_w: Optional[torch.Tensor] = None,  # [F, D] (gated aggregation)
    gen: Optional[torch.Generator] = None,
    train: bool = False,
) -> torch.Tensor:
    """Stacked-feature embedding: gather-sum (or gated sum) over F, embed
    dropout, and the `long` stack method's 1/#nonzero scaling."""
    dt = compute_dtype(cfg)
    table = embed_weight.to(dt)
    ids = input_ids.long()
    use_edrop = train and gen is not None and cfg.embed_dropout > 0
    if ids.dim() == 3 and cfg.stacked_feat_agg_method != "gated" and not use_edrop:
        emb = _EmbedLookupSum.apply(table, ids)
    else:
        # gated aggregation and per-element dropout need the [B, P, F, D] tensor
        emb = _EmbedLookup.apply(table, ids)
        emb = _dropout(emb, cfg.embed_dropout, gen, train)
        if ids.dim() == 3:
            if cfg.stacked_feat_agg_method == "gated":
                w = stacked_agg_w.to(dt).float()
                emb = torch.einsum("bsfd,fd->bsd", emb.float(), w).to(dt)
            else:
                emb = emb.sum(dim=-2)
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

    def forward(self, inputs_embeds, position_ids, segment_ids, seed: Optional[int] = None,
                train: bool = False):
        """[B, P, D] embeddings -> final-normed hidden states [B, P, D].
        `seed` feeds the per-layer dropout generators in training."""
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
        n_layers = len(self.layers)
        # linearly increasing stochastic-depth rate
        dp_rates = (
            torch.linspace(0.0, cfg.path_dropout, n_layers).tolist()
            if cfg.path_dropout > 0 else [0.0] * n_layers
        )
        # static gating: with every stochastic rate at 0 no generator is made
        stochastic = cfg.path_dropout > 0 or cfg.attention_dropout > 0 or cfg.mlp_dropout > 0
        needs_rng = train and seed is not None and stochastic
        # the MLP stays outside a rematerialised region when it is the fused
        # Function (which saves only its input and recomputes for itself)
        split_mlp = cfg.layer_scale_init_value > 0 or (
            needs_rng and (cfg.path_dropout > 0 or cfg.mlp_dropout > 0)
        )
        remat = cfg.remat and torch.is_grad_enabled()
        if remat and cfg.remat_policy in ("dots", "save_attn_mlp"):
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported yet (full, pairs, quads "
                "and save_attn are)"
            )
        group = {"pairs": 2, "quads": 4}.get(cfg.remat_policy, 1)
        if n_layers % group:
            group = 1
        stashes = [
            {} if remat and cfg.remat_policy == "save_attn" else None for _ in range(n_layers)
        ]

        def run(x, lo, hi, last_mlp):
            for i in range(lo, hi):
                layer = self.layers[i]
                gen = derive_generator(seed, i, x.device) if needs_rng else None
                x = layer.attn_half(x, cfg, b, p, segment_ids, rope, gen, dp_rates[i], train,
                                    stashes[i])
                if last_mlp or i < hi - 1:
                    x = layer.mlp_half(x, cfg, b, p, gen, dp_rates[i], train)
            return x

        if not remat:
            x = run(x, 0, n_layers, True)
        else:
            # Per group of layers only the input is kept: the backward runs the
            # group again. Under save_attn the flash kernel's (out, lse) are
            # kept too and the recompute does not launch it. Generators are
            # explicit, so no global RNG state has to be preserved.
            for lo in range(0, n_layers, group):
                hi = lo + group
                x = torch.utils.checkpoint.checkpoint(
                    run, x, lo, hi, split_mlp, use_reentrant=False, preserve_rng_state=False
                )
                if not split_mlp:
                    x = self.layers[hi - 1].mlp_half(x, cfg, b, p)
        return rms_norm(x, self.norm.weight, cfg.rms_norm_eps).view(b, p, d)


def plain_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF-Llama RMSNorm in torch ops, its gradient by autograd."""
    x32 = x.float()
    rrms = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rrms * weight.float()).to(x.dtype)


def add_raw_embeds(
    cfg: ModelConfig,
    inputs_embeds: torch.Tensor,  # [B, P, D]
    raw_embeds: torch.Tensor,  # [B, P, embed_dim]
    raw_params,  # (embed_layernorm [E], embed_proj [D, E], emb_mask_token [E])
    embed_is_masked: Optional[torch.Tensor] = None,  # [B, P] bool: the mask token
    gen: Optional[torch.Generator] = None,
    train: bool = False,
) -> torch.Tensor:
    """The raw float-feature branch (JAX `add_raw_embeds`,
    `models/modeling.py:332-352`; reference prepare_inputs_embeds,
    modeling_pretrain.py:119-150): mask-token substitution -> RMSNorm ->
    dropout -> linear projection -> added to the token embeddings. Its
    norm's gradient comes from autograd, as the JAX package's does by
    default (`GGT_RMSNORM_PALLAS` off); the rmsnorm_bwd kernel takes no
    D % 8 != 0 (ogbn-products' embed_dim is 100)."""
    ln_w, proj_w, mask_tok = raw_params
    dt = inputs_embeds.dtype
    x = raw_embeds.to(dt)
    if embed_is_masked is not None:
        x = torch.where(embed_is_masked[..., None], mask_tok.to(dt), x)
    x = plain_rms_norm(x, ln_w, cfg.rms_norm_eps)
    x = _dropout(x, cfg.embed_dropout, gen, train)
    return inputs_embeds + F.linear(x, proj_w.to(dt))


def model_hidden_states(
    backbone: Backbone,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    position_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    stacked_agg_w: Optional[torch.Tensor] = None,
    raw_embeds: Optional[torch.Tensor] = None,
    seed: Optional[int] = None,
    train: bool = False,
    raw_params=None,
    embed_is_masked: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Input embedding (+ the raw-embedding branch where the batch carries
    `embed` and cfg.embed_dim > 0) -> decoder -> final norm. `seed`
    (training) feeds the embed-dropout generator and the per-layer ones."""
    gen = None
    if train and seed is not None and cfg.embed_dropout > 0:
        gen = derive_generator(seed, -1, backbone.norm.weight.device)
    x = embed_inputs(backbone.embed_tokens.weight, cfg, input_ids, stacked_agg_w, gen, train)
    if raw_embeds is not None and cfg.embed_dim > 0:
        x = add_raw_embeds(cfg, x, raw_embeds, raw_params, embed_is_masked, gen, train)
    return backbone(x, position_ids, segment_ids, seed=seed, train=train)
