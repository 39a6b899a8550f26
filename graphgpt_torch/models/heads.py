"""SMTP pretrain model for inference: eval loss and generation logits.

Counterpart of `graphgpt_tpu/models/heads.py` (`init_pretrain_params` :29,
`last_token_pool` :77, `pretrain_forward` :128 in eval without
`smtp_inside` or CL, `pretrain_logits` :203).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..config import ModelConfig
from ..ops import losses
from .modeling import Backbone, _linear, compute_dtype, model_hidden_states


def last_token_pool(hidden: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """Hidden state at the last non-pad position of each row."""
    last = ((segment_ids > 0).sum(dim=-1) - 1).clamp(min=0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


class _Weight(nn.Module):
    def __init__(self, shape, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device))


class GraphGPTPretrain(nn.Module):
    """Backbone plus the generative SMTP head, under HF-Llama names
    (`model.*`, `lm_head`, `n_token_proj`, `stacked_feat_agg`).

    Weights are fp32, drawn from `seed` with the JAX init's distributions
    (normal(0, initializer_range) for the matrices, ones for the norms,
    uniform(+-1/sqrt(D)) for the gated aggregation). They are not the JAX
    init's numbers: load those with `load_state_dict(params_from_jax(...))`.
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.hidden_size
        self.model = Backbone(cfg, dev)
        if cfg.stacked_feat_agg_method == "gated" and cfg.stacked_feat > 1:
            self.stacked_feat_agg = _Weight((cfg.stacked_feat, d), dev)
        if cfg.use_generative:
            self.lm_head = _linear(dev, d, cfg.vocab_size)
            if cfg.next_n_token > 1:
                self.n_token_proj = _linear(dev, d, d * cfg.next_n_token)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        dev = self.model.norm.weight.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        std = self.cfg.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("norm.weight") or name.endswith("layernorm.weight"):
                p.fill_(1.0)
            elif ".lambda_" in name:
                p.fill_(self.cfg.layer_scale_init_value)
            elif name == "stacked_feat_agg.weight":
                bound = 1.0 / (self.cfg.hidden_size**0.5)
                p.uniform_(-bound, bound, generator=gen)
            else:
                p.normal_(0.0, std, generator=gen)
        if self.cfg.use_generative and self.cfg.tie_word_embeddings:
            # the JAX init copies the table (the two are not shared)
            self.lm_head.weight.copy_(self.model.embed_tokens.weight)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    def _agg_w(self) -> Optional[torch.Tensor]:
        agg = getattr(self, "stacked_feat_agg", None)
        return None if agg is None else agg.weight

    @torch.no_grad()
    def hidden_states(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return model_hidden_states(
            self.model, self.cfg, batch["input_ids"], batch["position_ids"],
            batch["segment_ids"], self._agg_w(), raw_embeds=batch.get("embed"),
        )

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Eval SMTP forward: {"hidden_states", "gen_loss", "loss"}."""
        cfg = self.cfg
        hidden = self.hidden_states(batch)
        out = {"hidden_states": hidden}
        labels = batch.get("labels")
        total = hidden.new_zeros((), dtype=torch.float32)
        if cfg.use_generative and labels is not None:
            lab3 = labels if labels.dim() == 3 else labels[..., None]
            b, p, n = lab3.shape
            token_wgt = dlm_norm = None
            if "wgt" in batch:
                token_wgt = batch["wgt"][:, None, None].float().expand(b, p, n)
                dlm_norm = float(b * p * n)
            gen_loss = losses.chunked_stacked_ce(
                hidden, lab3,
                self.n_token_proj.weight if cfg.next_n_token > 1 else None,
                self.lm_head.weight, token_wgt=token_wgt, dlm_normalizer=dlm_norm,
                focal_gamma=cfg.focal_gamma,
            )
            out["gen_loss"] = gen_loss
            total = total + gen_loss
        out["loss"] = total
        return out

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.forward(batch)["loss"]

    @torch.no_grad()
    def logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Generative logits [B, P, next_n, V] in fp32."""
        hidden = self.hidden_states(batch)
        b, p, d = hidden.shape
        n = self.cfg.next_n_token
        dt = compute_dtype(self.cfg)
        if n > 1:
            h = F.linear(hidden, self.n_token_proj.weight.to(dt)).view(b, p, n, d)
        else:
            h = hidden[:, :, None, :]
        return F.linear(h, self.lm_head.weight.to(dt)).float()
