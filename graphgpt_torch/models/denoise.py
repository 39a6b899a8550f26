"""The denoising regression double-heads fine-tune model (GraphGPTDenoise).

Counterpart of `graphgpt_tpu/models/denoise.py` (`init_denoise_params` :37,
`atom_task_head` :62, `denoise_cosine_loss` :88, `denoise_forward` :103).
Two heads over the shared backbone: the supervised energy (the pooled score
head, or, with `bi_causal_split > 0`, 16 bits decoded from the score logits
of the row's last 16 positions under the bi-causal mask) and coordinate
denoising by an equivariant attention head whose values are mixed by the
pairwise displacements, trained with 1 - cosine against the injected noise;
with `smtp_3d`, a third, auxiliary CE over the line tokens of the clean
coordinates. Training mixes 2D-only and 3D samples by the (r_2d, r_3d,
r_both) ratios.

Every random tensor that `denoise_forward` draws from its five keys (:117)
comes from `denoise_draws`; `forward` takes such draws as an argument, so
that a test can hand it the JAX package's own. Kept as the JAX package has
them: the embedding runs without dropout even in training (:168), the force
head's softmax runs over every key, padded ones included (:78-79), and a
forward given no generator (eval) draws its noise and schedule from a fixed
seed and reports a denoise loss against noise it never added.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops import losses
from .heads import GraphGPTTask, pool_hidden
from .modeling import _EmbedLookup, _EmbedLookupSum, _linear, compute_dtype, embed_inputs
from .pos_pretrain import discrete_pos, fixed_generator, line_vocab, pos_range, take_rows
from .rope import apply_rope, rope_cos_sin

MOL_ENERGY_BIN_LEN = 16
MOL_ENERGY_SCALE = 1000.0
_EPS = 1e-7


def denoise_draws(b: int, p: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every random tensor `denoise_forward` draws, from `generator`: `mode`
    [B, 1, 1] (key r_mode), `noise` [B, P, 3] standard normal (r_noise),
    `sched` [B, 1, 1] (r_sched) and `node` [B, P, 1] (r_node)."""
    return {
        "mode": torch.rand((b, 1, 1), generator=generator, device=device),
        "noise": torch.randn((b, p, 3), generator=generator, device=device),
        "sched": torch.rand((b, 1, 1), generator=generator, device=device),
        "node": torch.rand((b, p, 1), generator=generator, device=device),
    }


def denoise_cosine_loss(pred, noise, noise_mask) -> torch.Tensor:
    """1 - cos(pred, noise), averaged over the unmasked positions of each
    sample, then over the samples."""
    pred = torch.where(noise_mask, 0.0, pred.float())
    noise = noise.float()
    dot = (pred * noise).sum(dim=-1)
    na = torch.linalg.vector_norm(pred, dim=-1) + 1e-8
    nb = torch.linalg.vector_norm(noise, dim=-1) + 1e-8
    per = 1.0 - dot / (na * nb)
    valid = ~noise_mask[..., 0]
    per = torch.where(valid, per, 0.0).sum(dim=-1)
    cnt = valid.sum(dim=-1).float().clamp(min=1.0)
    return (per / cnt).mean()


def energy_bits(bit_logits: torch.Tensor, labels: Optional[torch.Tensor]):
    """(decoded energy [B], weighted BCE or None) of the 16 bit logits
    [B, 16], most significant first, in units of 1/1000."""
    nbits = MOL_ENERGY_BIN_LEN
    dev = bit_logits.device
    powers = torch.pow(2.0, torch.arange(nbits - 1, -1, -1, device=dev, dtype=torch.float32))
    unit = powers / MOL_ENERGY_SCALE
    wgt = ((torch.arange(nbits, device=dev) + 1) * 2.0 / (nbits + 1)).flip(0)
    energy = ((bit_logits > 0).float() * unit).sum(dim=-1)
    if labels is None:
        return energy, None
    y = labels.reshape(-1).float()
    bits = torch.floor(y[:, None] * MOL_ENERGY_SCALE / powers).to(torch.int32) % 2
    per = (torch.maximum(bit_logits, torch.zeros_like(bit_logits)) - bit_logits * bits
           + torch.log1p(torch.exp(-bit_logits.abs())))
    return energy, (per * wgt[None, :]).mean()


class _ForceHead(nn.Module):
    """q, k, v projections (`denoise.{q,k,v}.weight`, nn.Linear layout) and
    the three Linear(embed, 1) of the force (`denoise.force_w` [3, H*Dh],
    `denoise.force_b` [3])."""

    def __init__(self, cfg: ModelConfig, dev):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim
        self.q, self.k, self.v = (_linear(dev, d, hd) for _ in range(3))
        self.force_w = nn.Parameter(torch.empty(3, hd, device=dev))
        self.force_b = nn.Parameter(torch.zeros(3, device=dev))

    def forward(self, hidden, position_ids, delta_pos, cfg: ModelConfig) -> torch.Tensor:
        """Forces [B, P, 3] fp32 from hidden [B, P, D] and the normalised
        displacements delta_pos [B, P, P, 3] (`atom_task_head`)."""
        b, p, _ = hidden.shape
        h, dh = cfg.num_attention_heads, cfg.head_dim
        dt = hidden.dtype
        q = F.linear(hidden, self.q.weight.to(dt)).view(b, p, h, dh) * (dh**-0.5)
        k = F.linear(hidden, self.k.weight.to(dt)).view(b, p, h, dh)
        v = F.linear(hidden, self.v.weight.to(dt)).view(b, p, h, dh)
        cos, sin = rope_cos_sin(position_ids, dh, cfg.rope_theta)
        q, k = apply_rope(q, k, cos, sin)
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(attn, dim=-1).to(dt)  # over every key, padded ones too
        # values mixed by the displacements: [B, H, P, P, 1] * [B, 1, P, P, 3]
        rot = probs[..., None] * delta_pos[:, None].to(dt)
        x = torch.einsum("bhqkc,bkhd->bqchd", rot, v).reshape(b, p, 3, h * dh)
        force = torch.einsum("bpcf,cf->bpc", x.float(), self.force_w.float())
        return force + self.force_b[None, None, :]


class GraphGPTDenoise(GraphGPTTask):
    """`GraphGPTTask` (backbone, score head) plus, under the JAX package's
    names: the force head `denoise.*`, `embed_pos_type` (with
    `add_pos_type`), `embed_pos_token` (the line tokens of the noisy
    coordinates) and, with `smtp_3d`, `smtp_proj` and `smtp_head`."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__(cfg, device, seed)
        dev, d = self.device, cfg.hidden_size
        self.denoise = _ForceHead(cfg, dev)
        if cfg.add_pos_type:
            self.embed_pos_type = nn.utils.skip_init(nn.Embedding, 5, d, device=dev)
        self.embed_pos_token = nn.utils.skip_init(
            nn.Embedding, line_vocab(cfg, cfg.pos_num_bins), d, device=dev)
        if cfg.smtp_3d:
            self.smtp_proj = _linear(dev, d, 3 * d)
            self.smtp_head = _linear(dev, d, cfg.smtp_vocab)
        # again, now that the heads above exist (the backbone draws the same)
        self.reset_parameters(seed)

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
        train: bool = False, draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """{"hidden_states", "task_logits" (the decoded energy [B, 1] under a
        bi-causal split, else the pooled score), "pretrain_loss" (denoise),
        and with labels "task_loss", with smtp_3d "smtp_loss"; "loss" their
        sum}. `draws` (from `denoise_draws`) come from `generator` when not
        given, from a generator seeded 0 when neither is; `generator` also
        feeds the dropout masks in training."""
        cfg = self.cfg
        input_ids, pos_type, node_idx = batch["input_ids"], batch["pos_type"], batch["node_idx"]
        raw_pos = batch["pos"].float()
        b, p, _ = input_ids.shape
        dev = input_ids.device
        dt = compute_dtype(cfg)
        if draws is None:
            draws = denoise_draws(b, p, generator if generator is not None else
                                  fixed_generator(dev), dev)

        # per sample: a mask_3d_ratio share trains 2D-only
        if train:
            ratio = cfg.r_2d / max(cfg.r_2d + cfg.r_3d + cfg.r_both, _EPS)
            raw_pos = torch.where(draws["mode"] < ratio, 0.0, raw_pos)
        no_pos = (raw_pos.abs() < _EPS).all(dim=-1).all(dim=-1)  # [B]
        sample_mask = no_pos[:, None]
        pad_mask = pos_type > 0
        noise_mask = ((~pad_mask) | sample_mask)[..., None]  # [B, P, 1]
        # one noise a node, whichever of its visits
        gnoise = take_rows(draws["noise"] * cfg.noise_scale, node_idx)
        noise = torch.where(noise_mask, 0.0, gnoise)
        noisy_pos = raw_pos + (noise if train else 0.0)

        # node-level schedule masking: the 3D-SMTP targets with smtp_3d, a
        # curriculum with denoise_schedule_pow; a masked position loses its
        # noise, its coordinates and its position tokens
        sched_pow = cfg.smtp_3d_power if cfg.smtp_3d else (cfg.denoise_schedule_pow or None)
        mask1 = None  # [B, P, 1]
        if sched_pow is not None:
            u = draws["sched"]
            if sched_pow == -1:
                mr = torch.cos(u * math.pi / 2)
            elif sched_pow == -2:
                mr = 1.0 - (2.0 / math.pi) * torch.arccos(u)
            else:
                mr = u**sched_pow
            mask1 = take_rows(draws["node"] > mr, node_idx) & pad_mask[..., None]
            noise = torch.where(mask1, 0.0, noise)
            noisy_pos = torch.where(mask1, 0.0, noisy_pos)
            noise_mask = noise_mask | mask1

        delta_pos = noisy_pos[:, :, None, :] - noisy_pos[:, None, :, :]  # [B, P, P, 3]
        delta_pos = delta_pos / (torch.linalg.vector_norm(delta_pos, dim=-1, keepdim=True) + 1.0)

        embeds = embed_inputs(self.model.embed_tokens.weight, cfg, input_ids, self._agg_w())
        if cfg.add_pos_type:
            embeds = embeds + _EmbedLookup.apply(self.embed_pos_type.weight.to(dt),
                                                 pos_type.clamp(min=0).long())
        nb = cfg.pos_num_bins
        rmin, rmax = pos_range(cfg, dev)
        shift = torch.tensor([0, nb, 2 * nb] if cfg.pos_agg_method == "sum" else [0, 0, 0],
                             device=dev)
        tok = discrete_pos(noisy_pos, nb, rmin, rmax) + shift + 2
        tok = torch.where(sample_mask[..., None], 1, tok)
        if mask1 is not None:  # schedule-masked positions see the [mask] token
            tok = torch.where(mask1, 1, tok)
        tok = torch.where(~pad_mask[..., None], 0, tok)
        embeds = embeds + _EmbedLookupSum.apply(self.embed_pos_token.weight.to(dt), tok)

        seed = self._step_seed(generator, train, (cfg.attention_dropout, cfg.mlp_dropout,
                                                  cfg.path_dropout))
        hidden = self.model(embeds, batch["position_ids"], batch["segment_ids"], seed=seed,
                            train=train)
        out: Dict[str, torch.Tensor] = {"hidden_states": hidden}
        total = hidden.new_zeros((), dtype=torch.float32)

        # head 1: the energy
        labels = batch.get("graph_labels")
        logits_all = self.score_apply(hidden, None, False)  # [B, P, C]
        if cfg.bi_causal_split > 0:
            bit_logits = logits_all[:, -MOL_ENERGY_BIN_LEN:, 0].float()
            energy, task_loss = energy_bits(bit_logits, labels)
            out["task_logits"] = energy[:, None]
        else:
            pooled = pool_hidden(logits_all, batch["segment_ids"], cfg.pooling_method)
            out["task_logits"] = pooled.float()
            task_loss = None if labels is None else losses.regression_loss(
                pooled, labels, "l1" if cfg.loss_type == "l1" else "mse")
        if task_loss is not None:
            out["task_loss"] = task_loss
            total = total + task_loss

        # head 2: denoising
        force = self.denoise(hidden, batch["position_ids"], delta_pos, cfg)
        dn_loss = denoise_cosine_loss(force, noise, noise_mask) * cfg.denoise_wgt
        out["pretrain_loss"] = dn_loss
        total = total + dn_loss

        # head 3: the 3D-SMTP CE over the clean coordinates' line tokens at
        # the schedule-masked positions (every valid one with smtp_denoise)
        if cfg.smtp_3d and mask1 is not None:
            lab = discrete_pos(raw_pos, cfg.smtp_vocab, rmin, rmax) + 2  # [B, P, 3]
            keep = ~sample_mask[..., None]
            valid = (pad_mask[..., None] if cfg.smtp_denoise else mask1) & keep
            smtp_loss = losses.chunked_stacked_ce(
                hidden, torch.where(valid, lab, -100), self.smtp_proj.weight,
                self.smtp_head.weight,
            ) * cfg.smtp_wgt
            out["smtp_loss"] = smtp_loss
            total = total + smtp_loss
        out["loss"] = total
        return out
