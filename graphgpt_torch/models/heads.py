"""The SMTP pretrain model (training forward, eval loss, generation logits)
and the fine-tune task model (score head, pooling, task losses, the
auxiliary NTP head).

Counterpart of `graphgpt_tpu/models/heads.py` (`init_pretrain_params` :29,
`init_task_params` :47, `last_token_pool` :77, `pool_hidden` :86,
`smtp_inside_mask` :95, `pretrain_forward` :128, `pretrain_logits` :203,
`score_apply` :226, `task_forward` :247, `_auc_loss_from_labels` :343).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..config import ModelConfig
from ..ops import losses
from ..ops.mlp import act_fn
from .modeling import (
    Backbone,
    _dropout,
    _linear,
    compute_dtype,
    derive_generator,
    model_hidden_states,
)


def last_token_pool(hidden: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """Hidden state at the last non-pad position of each row."""
    last = ((segment_ids > 0).sum(dim=-1) - 1).clamp(min=0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


def pool_hidden(hidden: torch.Tensor, segment_ids: torch.Tensor, method: str) -> torch.Tensor:
    """The last non-pad position (`last`), or the sum or mean over the
    non-pad positions of each row."""
    if method == "last":
        return last_token_pool(hidden, segment_ids)
    valid = (segment_ids > 0).to(hidden.dtype)[..., None]
    summed = (hidden * valid).sum(dim=1)
    if method == "sum":
        return summed
    return summed / (valid.sum(dim=1) + 1e-7)


def smtp_inside_mask_from_draws(
    input_ids: torch.Tensor,  # [B, P, F]
    node_idx: torch.Tensor,  # [B, P] int; row to draw the mask from (>= 0)
    t: torch.Tensor,  # [B, 1, 1] uniform draws: one mask ratio per sample
    u: torch.Tensor,  # [B, P, F] uniform draws: one per (node, feature)
    *,
    power: float = 1.0,
    mask_token_id: int = 1,
    replace_rate: float = 0.0,
    replace_u: Optional[torch.Tensor] = None,  # [B, P, F] uniform draws
    replace_tokens: Optional[torch.Tensor] = None,  # [B, P, F] ids in [1, vocab)
):
    """SMTP masking as a pure function of its random draws: a cell is masked
    where u > t**power, read at slot node_idx so that all visits of a node
    share one mask; labels are the original ids at masked cells, else -100."""
    b = input_ids.shape[0]
    mask_per_node = u > t**power
    rows = torch.arange(b, device=input_ids.device)[:, None]
    mask_per_token = mask_per_node[rows, node_idx.long()] & (input_ids > 0)
    labels = torch.where(mask_per_token, input_ids, -100)
    masked = torch.where(mask_per_token, mask_token_id, input_ids)
    if replace_rate > 0:
        replace = (replace_u < replace_rate) & mask_per_token
        masked = torch.where(replace, replace_tokens.to(masked.dtype), masked)
    return masked, labels


def smtp_inside_mask(
    input_ids, node_idx, generator: torch.Generator, *, power: float = 1.0,
    mask_token_id: int = 1, replace_rate: float = 0.0, vocab_size: int = 2,
):
    """`smtp_inside_mask_from_draws` with the draws taken from `generator`."""
    b, p, f = input_ids.shape
    dev = input_ids.device
    t = torch.rand((b, 1, 1), generator=generator, device=dev)
    u = torch.rand((b, p, f), generator=generator, device=dev)
    ru = rtok = None
    if replace_rate > 0:
        ru = torch.rand((b, p, f), generator=generator, device=dev)
        rtok = torch.randint(1, vocab_size, (b, p, f), generator=generator, device=dev)
    return smtp_inside_mask_from_draws(
        input_ids, node_idx, t, u, power=power, mask_token_id=mask_token_id,
        replace_rate=replace_rate, replace_u=ru, replace_tokens=rtok,
    )


class _Weight(nn.Module):
    def __init__(self, shape, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device))


class _GraphGPTBase(nn.Module):
    """The backbone and the gated aggregation weight, with the init and the
    per-step seed that both models share. Weights are fp32, drawn from
    `seed` with the JAX init's distributions (normal(0, initializer_range)
    for the matrices, ones for the norms, zeros for the biases,
    uniform(+-1/sqrt(D)) for the gated aggregations). They are not the JAX
    init's numbers: load those with `load_state_dict(params_from_jax(...))`."""

    def __init__(self, cfg: ModelConfig, dev: torch.device):
        super().__init__()
        self.cfg = cfg
        self.model = Backbone(cfg, dev)
        if cfg.stacked_feat_agg_method == "gated" and cfg.stacked_feat > 1:
            self.stacked_feat_agg = _Weight((cfg.stacked_feat, cfg.hidden_size), dev)
        if cfg.embed_dim > 0:  # the raw-embedding branch
            self.embed_layernorm = _Weight((cfg.embed_dim,), dev)
            self.embed_proj = _linear(dev, cfg.embed_dim, cfg.hidden_size)
            self.emb_mask_token = nn.Parameter(torch.empty(cfg.embed_dim, device=dev))

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
            elif name.endswith((".bias", "force_b")):
                p.zero_()
            elif name in ("stacked_feat_agg.weight", "pos_token_agg_w"):
                bound = 1.0 / (self.cfg.hidden_size**0.5)
                p.uniform_(-bound, bound, generator=gen)
            else:
                p.normal_(0.0, std, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    def _agg_w(self) -> Optional[torch.Tensor]:
        agg = getattr(self, "stacked_feat_agg", None)
        return None if agg is None else agg.weight

    def _raw_params(self):
        """The raw-embedding branch's weights (norm, projection, mask
        token), or None."""
        if not hasattr(self, "embed_proj"):
            return None
        return self.embed_layernorm.weight, self.embed_proj.weight, self.emb_mask_token

    def _step_seed(self, generator: Optional[torch.Generator], train: bool,
                   rates) -> Optional[int]:
        """One draw a step when a stochastic rate is on; the per-layer
        generators derive from it."""
        if train and generator is not None and max(rates) > 0:
            return int(torch.randint(2**62, (1,), generator=generator,
                                     device=generator.device).item())
        return None


class GraphGPTPretrain(_GraphGPTBase):
    """Backbone plus the generative SMTP head and the optional contrastive
    one, under HF-Llama names (`model.*`, `lm_head`, `n_token_proj`,
    `stacked_feat_agg`, `cl_proj`)."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__(cfg, dev)
        d = cfg.hidden_size
        if cfg.use_generative:
            self.lm_head = _linear(dev, d, cfg.vocab_size)
            if cfg.next_n_token > 1:
                self.n_token_proj = _linear(dev, d, d * cfg.next_n_token)
        if cfg.use_discriminative:
            self.cl_proj = _linear(dev, d, d)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        super().reset_parameters(seed)
        if self.cfg.use_generative and self.cfg.tie_word_embeddings:
            # the JAX init copies the table (the two are not shared)
            self.lm_head.weight.copy_(self.model.embed_tokens.weight)

    @torch.no_grad()
    def hidden_states(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return model_hidden_states(
            self.model, self.cfg, batch["input_ids"], batch["position_ids"],
            batch["segment_ids"], self._agg_w(), raw_embeds=batch.get("embed"),
            raw_params=self._raw_params(),
        )

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """SMTP (and optional contrastive) forward with its loss:
        {"hidden_states", "gen_loss", "dis_loss", "loss"}. Differentiable;
        `generator` feeds the in-model SMTP masking and, in training, the
        dropout masks."""
        cfg = self.cfg
        input_ids, labels = batch["input_ids"], batch.get("labels")
        if cfg.smtp_inside:
            if generator is None:
                raise ValueError("smtp_inside draws its masks from `generator`")
            input_ids, labels = smtp_inside_mask(
                input_ids, batch["node_idx"], generator, power=cfg.smtp_power,
                mask_token_id=cfg.mask_token_id, vocab_size=cfg.vocab_size,
            )
        seed = self._step_seed(generator, train, (cfg.attention_dropout, cfg.embed_dropout,
                                                  cfg.mlp_dropout, cfg.path_dropout))
        hidden = model_hidden_states(
            self.model, cfg, input_ids, batch["position_ids"], batch["segment_ids"],
            self._agg_w(), raw_embeds=batch.get("embed"), seed=seed, train=train,
            raw_params=self._raw_params(),
            embed_is_masked=(labels != -100).any(dim=-1)
            if labels is not None and labels.dim() == 3 else None,
        )
        out = {"hidden_states": hidden}
        total = hidden.new_zeros((), dtype=torch.float32)
        if cfg.use_generative and labels is not None:
            lab3 = labels if labels.dim() == 3 else labels[..., None]
            b, p, n = lab3.shape
            token_wgt = dlm_norm = None
            if "wgt" in batch:
                token_wgt = batch["wgt"][:, None, None].float().expand(b, p, n)
                dlm_norm = None if cfg.smtp_inside else float(b * p * n)
            gen_loss = losses.chunked_stacked_ce(
                hidden, lab3,
                self.n_token_proj.weight if cfg.next_n_token > 1 else None,
                self.lm_head.weight, token_wgt=token_wgt, dlm_normalizer=dlm_norm,
                focal_gamma=cfg.focal_gamma,
            )
            out["gen_loss"] = gen_loss
            total = total + gen_loss
        if cfg.use_discriminative:
            pooled = last_token_pool(hidden, batch["segment_ids"])
            proj = F.linear(pooled.float(), self.cl_proj.weight.float())
            embeds = proj / (proj.norm(dim=-1, keepdim=True) + 1e-7)
            ratio = 0.5 if cfg.use_generative else 1.0
            dis_loss = losses.info_nce(embeds[0::2], embeds[1::2]) * ratio
            out["dis_loss"] = dis_loss
            total = total + dis_loss
        out["loss"] = total
        return out

    @torch.no_grad()
    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The eval loss (no dropout, no graph)."""
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


def auc_neg_idx(n: int, num_neg: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The [n, num_neg] negative candidates of the AUC loss, uniform over the
    batch. Without a generator the draw is fixed (a generator seeded 0), as
    the JAX package's `PRNGKey(0)` fallback is: its train step passes no
    loss key, so every step pairs the same positions."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    idx = torch.randint(0, n, (n, num_neg), generator=generator, device=generator.device)
    return idx.to(device)


def auc_loss_from_labels(y_pred: torch.Tensor, y_true: torch.Tensor,
                         neg_idx: torch.Tensor) -> torch.Tensor:
    """Squared pairwise AUC surrogate with the positives and negatives split
    by label: every position is paired with its `neg_idx` candidates, and a
    pair counts when the first is positive and the second negative."""
    y_pred = y_pred.float().reshape(-1)
    y_true = y_true.reshape(-1) > 0.5
    neg_scores = y_pred[neg_idx]
    w = (y_true[:, None] & ~y_true[neg_idx]).float()
    per = (1.0 - (y_pred[:, None] - neg_scores)).square()
    return (per * w).sum() / (w.sum() + 1e-7)


_LABEL_KEYS = ("graph_labels", "node_labels", "edge_labels", "task_labels")


class GraphGPTTask(_GraphGPTBase):
    """Backbone plus the fine-tune score head, under HF-Llama names
    (`model.*`, `stacked_feat_agg`, `score` (a linear layer, with a bias for
    regression) or `score_mlp.{i}`, and with `use_aux` the NTP head
    `lm_head`, `n_token_proj`)."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__(cfg, dev)
        d = cfg.hidden_size
        bias = cfg.problem_type == "regression"
        if cfg.mlp:
            sizes = [d, *cfg.mlp, cfg.num_labels]
            self.score_mlp = nn.ModuleList(
                nn.utils.skip_init(nn.Linear, a, b, bias=bias, device=dev)
                for a, b in zip(sizes[:-1], sizes[1:])
            )
        else:
            self.score = nn.utils.skip_init(nn.Linear, d, cfg.num_labels, bias=bias, device=dev)
        if cfg.use_aux:
            self.lm_head = _linear(dev, d, cfg.vocab_size)
            if cfg.next_n_token > 1:
                self.n_token_proj = _linear(dev, d, d * cfg.next_n_token)
        self.reset_parameters(seed)

    def score_apply(self, x: torch.Tensor, gen: Optional[torch.Generator], train: bool):
        """Per-position scores [..., num_labels] in x's dtype; the score MLP
        applies act -> dropout -> linear per block."""
        dt = x.dtype
        layers = self.score_mlp if self.cfg.mlp else [self.score]
        for layer in layers:
            if self.cfg.mlp:
                x = act_fn(self.cfg.hidden_act)(x)
                x = _dropout(x, self.cfg.head_dropout, gen, train)
            x = F.linear(x, layer.weight.to(dt))
            if layer.bias is not None:
                x = x + layer.bias.to(dt)
        return x

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
        train: bool = False, loss_generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Score every position, then pool; the problem type's loss where the
        batch has labels: {"task_logits", "task_hidden_states",
        "hidden_states", and "task_loss", "loss" (and "pretrain_loss" with
        the auxiliary head)}. `generator` feeds the dropout masks in
        training; `loss_generator` the AUC loss's negatives."""
        cfg = self.cfg
        seed = self._step_seed(generator, train, (cfg.attention_dropout, cfg.embed_dropout,
                                                  cfg.mlp_dropout, cfg.path_dropout,
                                                  cfg.head_dropout))
        hidden = model_hidden_states(
            self.model, cfg, batch["input_ids"], batch["position_ids"], batch["segment_ids"],
            self._agg_w(), raw_embeds=batch.get("embed"), seed=seed, train=train,
            raw_params=self._raw_params(),
        )
        gen = derive_generator(seed, -2, hidden.device) if seed is not None else None
        logits_all = self.score_apply(hidden, gen, train)  # [B, P, C]
        seg = batch["segment_ids"]
        pooled = pool_hidden(logits_all, seg, cfg.pooling_method)
        out = {
            "task_logits": pooled.float(),
            "task_hidden_states": pool_hidden(hidden, seg, cfg.pooling_method),
            "hidden_states": hidden,
        }
        c = cfg.num_labels
        if cfg.task_type == "nodev2" and "nodev2_labels" in batch:
            # token-level node classification
            if cfg.loss_type == "token_ce_intra":
                h = hidden.float()
                h = h / (h.norm(dim=-1, keepdim=True) + 1e-7)
                offs = batch["cls_idx"].reshape(-1, 1).long() + torch.arange(c, device=h.device)
                lle = h[torch.arange(h.shape[0], device=h.device)[:, None], offs]  # [B, C, D]
                logits_tok = torch.einsum("bpd,bcd->bpc", h, lle) * 20.0
            else:  # token_ce
                logits_tok = logits_all.float()
            loss = losses.masked_mean_ce(
                logits_tok.reshape(-1, c), batch["nodev2_labels"].reshape(-1).long()
            )
            out.update(task_logits=logits_tok, task_loss=loss, loss=loss)
            return out
        labels = next((batch[k] for k in _LABEL_KEYS if k in batch), None)
        if labels is None:
            return out
        sample_wgt = batch.get("sample_wgt", batch.get("wgt"))
        if cfg.problem_type == "regression":
            loss = losses.regression_loss(pooled, labels, "l1" if cfg.loss_type == "l1" else "mse")
        elif cfg.problem_type == "single_label_classification":
            if cfg.loss_type == "auc":
                y_true = labels.reshape(-1)
                neg = auc_neg_idx(y_true.shape[0], cfg.num_neg, loss_generator, y_true.device)
                loss = auc_loss_from_labels(pooled[:, 1] - pooled[:, 0], y_true, neg)
            else:
                loss = losses.single_label_ce(
                    pooled.reshape(-1, c), labels.reshape(-1).long(), sample_wgt
                )
        else:  # multi_label_classification
            loss = losses.multi_label_bce(pooled.reshape(-1, c), labels.reshape(-1, c), sample_wgt)
        out["task_loss"] = loss
        total = loss
        if cfg.use_aux and "labels" in batch:
            lab3 = batch["labels"] if batch["labels"].dim() == 3 else batch["labels"][..., None]
            aux = losses.chunked_stacked_ce(
                hidden, lab3, self.n_token_proj.weight if cfg.next_n_token > 1 else None,
                self.lm_head.weight,
            )
            out["pretrain_loss"] = aux
            total = total + aux
        out["loss"] = total
        return out
