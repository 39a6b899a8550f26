"""Weights between the JAX package's params tree and the port's state dict.

The JAX tree stacks per-layer weights on a leading [L, ...] axis and keeps
matrices as [in, out]; the port's state dict uses HF-Llama names with
nn.Linear's [out, in] layout (the mapping of graphgpt_tpu/utils/convert.py):

    embed_tokens              model.embed_tokens.weight
    final_norm                model.norm.weight
    layers.attn_norm[i]       model.layers.{i}.input_layernorm.weight
    layers.mlp_norm[i]        model.layers.{i}.post_attention_layernorm.weight
    layers.{q,k,v,o}[i]       model.layers.{i}.self_attn.{q,k,v,o}_proj.weight (T)
    layers.{gate,up,down}[i]  model.layers.{i}.mlp.{gate,up,down}_proj.weight (T)
    layers.ls{1,2}[i]         model.layers.{i}.lambda_{1,2}
    lm_head, n_token_proj     lm_head.weight, n_token_proj.weight (T)
    stacked_agg_w             stacked_feat_agg.weight

Arrays cross as numpy: the tree may hold numpy arrays or anything that
`np.asarray` reads.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device

_PROJ = (
    ("q", "self_attn.q_proj"),
    ("k", "self_attn.k_proj"),
    ("v", "self_attn.v_proj"),
    ("o", "self_attn.o_proj"),
    ("gate", "mlp.gate_proj"),
    ("up", "mlp.up_proj"),
    ("down", "mlp.down_proj"),
)
_NORMS = (
    ("attn_norm", "input_layernorm.weight"),
    ("mlp_norm", "post_attention_layernorm.weight"),
    ("ls1", "lambda_1"),
    ("ls2", "lambda_2"),
)
_HEADS = (("lm_head", "lm_head.weight"), ("n_token_proj", "n_token_proj.weight"))


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """JAX params tree -> the port's fp32 state dict on `device` (cuda
    unless named)."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, order="C")).to(dev)

    sd = {
        "model.embed_tokens.weight": t(tree["embed_tokens"]),
        "model.norm.weight": t(tree["final_norm"]),
    }
    lp = tree["layers"]
    for i in range(np.asarray(lp["attn_norm"]).shape[0]):
        pre = f"model.layers.{i}"
        for ours, theirs in _PROJ:
            sd[f"{pre}.{theirs}.weight"] = t(np.asarray(lp[ours][i]).T)
        for ours, theirs in _NORMS:
            if ours in lp:
                sd[f"{pre}.{theirs}"] = t(lp[ours][i])
    for ours, theirs in _HEADS:
        if ours in tree:
            sd[theirs] = t(np.asarray(tree[ours]).T)
    if "stacked_agg_w" in tree:
        sd["stacked_feat_agg.weight"] = t(tree["stacked_agg_w"])
    return sd


def params_to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> a JAX-layout params tree of numpy arrays."""

    def a(x):
        return x.detach().float().cpu().numpy()

    n_layers = 1 + max(
        int(k.split(".")[2]) for k in sd if k.startswith("model.layers.")
    )
    layers: Dict[str, np.ndarray] = {}
    for ours, theirs in _PROJ:
        layers[ours] = np.stack(
            [a(sd[f"model.layers.{i}.{theirs}.weight"]).T for i in range(n_layers)]
        )
    for ours, theirs in _NORMS:
        if f"model.layers.0.{theirs}" in sd:
            layers[ours] = np.stack([a(sd[f"model.layers.{i}.{theirs}"]) for i in range(n_layers)])
    tree: Dict[str, Any] = {
        "embed_tokens": a(sd["model.embed_tokens.weight"]),
        "final_norm": a(sd["model.norm.weight"]),
        "layers": layers,
    }
    for ours, theirs in _HEADS:
        if theirs in sd:
            tree[ours] = a(sd[theirs]).T
    if "stacked_feat_agg.weight" in sd:
        tree["stacked_agg_w"] = a(sd["stacked_feat_agg.weight"])
    return tree
