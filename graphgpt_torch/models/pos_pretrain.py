"""The 3D-position pretraining model (GraphGPTPosPred).

Counterpart of `graphgpt_tpu/models/pos_pretrain.py` (`init_pos_pred_params`
:38, `_discrete_pos` :75, `_make_discrete_pos` :83, `_schedule_ratio` :104,
`pos_pred_forward` :112). It trains, jointly, 2D SMTP over the attribute
tokens of samples without coordinates and 3D SMTP over discretised
coordinates: line tokens (three a position, shifted per axis under sum
aggregation), cube tokens (a bins^3 vocabulary with a weight-tied head), or
both (mix); with Gaussian coordinate noise, a per-sample mask-ratio schedule
and the position-type embedding.

Every random tensor that `pos_pred_forward` draws from its keys comes from
`pos_draws`; `forward` takes such draws as an argument, so that a test can
hand it the JAX package's own. The JAX function draws both the 2D mask
ratio and the per-cell 2D draws from one key (`r_2d`, :146-147); the port
draws them from its generator one after the other.

Also the helpers that the denoise model shares: `take_rows` (the JAX
package's gather rule for node indices) and `discrete_pos` (uniform
binning over `DICT_RANGE`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..config import ModelConfig
from ..data.mol3d import DICT_RANGE
from ..ops import losses
from .heads import _GraphGPTBase
from .modeling import _EmbedLookup, _EmbedLookupSum, _linear, compute_dtype, embed_inputs

_EPS = 1e-7


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, t]] for x [B, N, ...] and idx [B, T], with the gather rule
    of JAX indexing: a negative index counts from the end once, then every
    index is clamped into [0, N)."""
    n = x.shape[1]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def pos_range(cfg: ModelConfig, device) -> tuple:
    """(range_min, range_max) fp32 [3] of `cfg.pos_range`."""
    lo, hi = DICT_RANGE[cfg.pos_range]
    return torch.as_tensor(lo, device=device), torch.as_tensor(hi, device=device)


def discrete_pos(pos: torch.Tensor, num_bins: int, range_min, range_max) -> torch.Tensor:
    """Uniform bins in [0, num_bins): (pos - min) * ((bins - 1) / span),
    truncated toward zero, clipped."""
    bins = (pos - range_min) * ((num_bins - 1) / (range_max - range_min))
    return bins.to(torch.int32).clamp(0, num_bins - 1).long()


def _make_discrete_pos(batch: Dict[str, torch.Tensor]):
    """The discretiser: the batch's percentile boundaries for a bin count
    (`pos_boundaries_{num_bins}`) where it carries them, bucketized after a
    clip to [-99, 99]; uniform `DICT_RANGE` binning otherwise."""

    def disc(pos, num_bins, range_min, range_max):
        key = f"pos_boundaries_{num_bins}"
        if key in batch:
            bounds = batch[key].float().contiguous()
            return torch.searchsorted(bounds, pos.clamp(-99.0, 99.0).contiguous()) - 1
        return discrete_pos(pos, num_bins, range_min, range_max)

    return disc


def _schedule_ratio(u: torch.Tensor, power: float) -> torch.Tensor:
    """The per-sample mask ratio: arccos (-2), cosine (-1) or u**power."""
    if power == -2:
        return torch.arccos(u * 2 - 1) / math.pi
    if power == -1:
        return 0.5 * torch.cos(math.pi * u) + 0.5
    return u**power


def pos_draws(b: int, p: int, f: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every random tensor `pos_pred_forward` draws, from `generator`:
    `sep` [B, 1, 1] (key r_sep), `t2` [B, 1, 1] and `u2` [B, P, F] (both
    r_2d), `noise` [B, P, 3] standard normal (r_noise), `mask_u` [B, 1, 1]
    (r_mask) and `coord_u` [B, P, 3] (r_coord)."""

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {
        "sep": rand(b, 1, 1), "t2": rand(b, 1, 1), "u2": rand(b, p, f),
        "noise": torch.randn((b, p, 3), generator=generator, device=device),
        "mask_u": rand(b, 1, 1), "coord_u": rand(b, p, 3),
    }


def fixed_generator(device) -> torch.Generator:
    """The generator of a forward that is given none: seeded 0, as the JAX
    package falls back to `PRNGKey(0)`."""
    return torch.Generator(device=device).manual_seed(0)


def _table(dev, rows: int, d: int) -> nn.Embedding:
    return nn.utils.skip_init(nn.Embedding, rows, d, device=dev)


def line_vocab(cfg: ModelConfig, num_bins: int) -> int:
    """Line-token vocabulary: [pad], [mask], then the bins (three shifted
    ranges under sum aggregation)."""
    return num_bins * 3 + 2 if cfg.pos_agg_method == "sum" else num_bins + 2


class GraphGPTPosPred(_GraphGPTBase):
    """Backbone, the 2D SMTP head (`lm_head`, `n_token_proj`) and the 3D
    heads of `cfg.pos_problem_type`, under the JAX package's names where HF
    has none: `embed_pos_type`, `embed_pos_token`, `pos_bins_proj`,
    `pos_bins_head`, `pos_token_agg_w` (line); `embed_pos_token` (cube, its
    own head); `embed_line_token`, `line_token_proj`, `line_token_head`,
    `embed_cube_token`, `cube_token_proj` (mix)."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__(cfg, dev)
        d = cfg.hidden_size
        self.embed_pos_type = _table(dev, 5, d)
        self.lm_head = _linear(dev, d, cfg.vocab_size)
        if cfg.next_n_token > 1:
            self.n_token_proj = _linear(dev, d, d * cfg.next_n_token)
        kind = cfg.pos_problem_type
        if kind == "pos-smtp-line":
            vocab = line_vocab(cfg, cfg.pos_num_bins)
            self.embed_pos_token = _table(dev, vocab, d)
            self.pos_bins_proj = _linear(dev, d, 3 * d)
            self.pos_bins_head = _linear(dev, d, vocab - 2)
            if cfg.pos_agg_method == "gated":
                self.pos_token_agg_w = nn.Parameter(torch.empty(3, d, device=dev))
        elif kind == "pos-smtp-cube":
            self.embed_pos_token = _table(dev, cfg.pos_num_bins**3 + 2, d)
        elif kind == "pos-smtp-mix":
            vocab = line_vocab(cfg, cfg.pos_num_bins_line)
            self.embed_line_token = _table(dev, vocab, d)
            self.line_token_proj = _linear(dev, d, 3 * d)
            self.line_token_head = _linear(dev, d, vocab)
            self.embed_cube_token = _table(dev, cfg.pos_num_bins_cube**3 + 2, d)
            self.cube_token_proj = _linear(dev, d, d)
        else:
            raise ValueError(f"pos_problem_type {kind!r}")
        self.reset_parameters(seed)

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
        train: bool = False, draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """{"loss", "gen_loss" (the 3D CE), "pretrain_loss" (the 2D CE, plus
        the cube CE under mix), "hidden_states"}. `draws` (from `pos_draws`)
        are taken from `generator` when not given, and from a generator
        seeded 0 when neither is; `generator` also feeds the dropout masks
        in training."""
        cfg = self.cfg
        input_ids, pos_type, node_idx = batch["input_ids"], batch["pos_type"], batch["node_idx"]
        raw_pos = batch["pos"].float()
        b, p, f = input_ids.shape
        dev = input_ids.device
        dt = compute_dtype(cfg)
        if draws is None:
            draws = pos_draws(b, p, f, generator if generator is not None else
                              fixed_generator(dev), dev)
        if cfg.sep_2d3d_inputs and train:
            # this fraction of the samples trains the 2D objective only
            raw_pos = torch.where(draws["sep"] < cfg.smtp_2d_rate, 0.0, raw_pos)
        no_pos = (raw_pos.abs() < _EPS).all(dim=-1).all(dim=-1)  # [B]
        if "labels" in batch and cfg.task_type == "pretrain-mlm-coord":
            # the tokenizer masked the inputs already; labels are its 2D targets
            labels_2d, masked_ids = batch["labels"], input_ids
        else:
            # 2D SMTP in the model, on the samples without coordinates
            per_node = (draws["u2"] > draws["t2"]) & no_pos[:, None, None]
            mask_tok = take_rows(per_node, node_idx) & (input_ids > 0)
            labels_2d = torch.where(mask_tok, input_ids, -100)
            masked_ids = torch.where(mask_tok, cfg.mask_token_id, input_ids)

        sample_mask = no_pos[:, None]  # [B, 1]
        pad_mask = pos_type > 0
        noise_mask = (~pad_mask) | sample_mask
        # one noise a node, whichever of its visits
        gnoise = take_rows(draws["noise"] * cfg.smtp_3d_noise_scale, node_idx)
        noise = torch.where(noise_mask[..., None], 0.0, gnoise)
        noisy_pos = raw_pos + (noise if train else 0.0)

        m_node = draws["coord_u"] > _schedule_ratio(draws["mask_u"], cfg.smtp_3d_power)
        if not cfg.coord_lvl_mask:
            m_node = m_node[:, :, 0:1].expand(m_node.shape)
        mask3 = take_rows(m_node, node_idx) & pad_mask[:, :, None]  # [B, P, 3]
        rmin, rmax = pos_range(cfg, dev)
        disc = _make_discrete_pos(batch)
        keep = (~sample_mask[..., None]) & pad_mask[..., None]  # [B, P, 1]

        embeds = embed_inputs(self.model.embed_tokens.weight, cfg, masked_ids, self._agg_w())
        embeds = embeds + _EmbedLookup.apply(self.embed_pos_type.weight.to(dt),
                                             pos_type.clamp(min=0).long())
        labels_cube = None
        kind = cfg.pos_problem_type
        if kind in ("pos-smtp-line", "pos-smtp-mix"):
            nl = cfg.pos_num_bins if kind == "pos-smtp-line" else cfg.pos_num_bins_line
            shift = torch.tensor([0, nl, 2 * nl] if cfg.pos_agg_method == "sum" else [0, 0, 0],
                                 device=dev)
            tok = disc(torch.where(mask3, 0.0, noisy_pos), nl, rmin, rmax) + shift + 2
            tok = torch.where(sample_mask[..., None] | mask3, 1, tok)  # [mask]
            tok = torch.where(~pad_mask[..., None], 0, tok)  # [pad]
            lab = disc(raw_pos, nl, rmin, rmax) + shift
            if kind == "pos-smtp-mix":
                lab = lab + 2
            labels_3d = torch.where(mask3 & keep, lab, -100)
        if kind == "pos-smtp-line":
            table = self.embed_pos_token.weight.to(dt)
            if cfg.pos_agg_method == "gated":
                pos_embeds = torch.einsum("bpcd,cd->bpd", _EmbedLookup.apply(table, tok),
                                          self.pos_token_agg_w.to(dt))
            else:
                pos_embeds = _EmbedLookupSum.apply(table, tok)
        else:
            nc = cfg.pos_num_bins if kind == "pos-smtp-cube" else cfg.pos_num_bins_cube
            mult = torch.tensor([nc * nc, nc, 1], device=dev)
            m_any = mask3.any(dim=-1)
            ct = (disc(noisy_pos, nc, rmin, rmax) * mult).sum(dim=-1) + 2
            ct = torch.where(sample_mask | m_any, 1, ct)
            ct = torch.where(~pad_mask, 0, ct)
            lab_c = (disc(raw_pos, nc, rmin, rmax) * mult).sum(dim=-1) + 2
            lab_c = torch.where(m_any & keep[..., 0], lab_c, -100)[..., None]
            cube = self.embed_pos_token if kind == "pos-smtp-cube" else self.embed_cube_token
            pos_embeds = _EmbedLookup.apply(cube.weight.to(dt), ct)
            if kind == "pos-smtp-cube":
                labels_3d = lab_c
            else:
                labels_cube = lab_c
                pos_embeds = pos_embeds + _EmbedLookupSum.apply(
                    self.embed_line_token.weight.to(dt), tok)
        seed = self._step_seed(generator, train, (cfg.attention_dropout, cfg.mlp_dropout,
                                                  cfg.path_dropout))
        hidden = self.model(embeds + pos_embeds, batch["position_ids"], batch["segment_ids"],
                            seed=seed, train=train)

        def agg_wgt(lab):
            # sample-lvl: each valid label weighs 1 / its sample's count
            if cfg.loss_agg == "token-lvl":
                return None
            valid = (lab != -100).float()
            return valid / (valid.sum(dim=(1, 2), keepdim=True) + 1e-9)

        aux = losses.chunked_stacked_ce(
            hidden, labels_2d, self.n_token_proj.weight if cfg.next_n_token > 1 else None,
            self.lm_head.weight, token_wgt=agg_wgt(labels_2d), focal_gamma=cfg.focal_gamma,
        )
        if kind == "pos-smtp-line":
            loss_3d = losses.chunked_stacked_ce(
                hidden, labels_3d, self.pos_bins_proj.weight, self.pos_bins_head.weight,
                token_wgt=agg_wgt(labels_3d))
        elif kind == "pos-smtp-cube":
            # the head is the embedding table itself (weight-tied)
            loss_3d = losses.chunked_stacked_ce(
                hidden, labels_3d, None, self.embed_pos_token.weight,
                token_wgt=agg_wgt(labels_3d))
        else:
            loss_3d = losses.chunked_stacked_ce(
                hidden, labels_3d, self.line_token_proj.weight, self.line_token_head.weight,
                token_wgt=agg_wgt(labels_3d))
            cube_hidden = F.linear(hidden, self.cube_token_proj.weight.to(hidden.dtype))
            aux = aux + losses.chunked_stacked_ce(
                cube_hidden, labels_cube, None, self.embed_cube_token.weight,
                token_wgt=agg_wgt(labels_cube))
        return {"loss": loss_3d + aux, "gen_loss": loss_3d, "pretrain_loss": aux,
                "hidden_states": hidden}
