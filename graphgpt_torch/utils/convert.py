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
    cl_proj                   cl_proj.weight (T)
    score_w, score_b          score.weight (T), score.bias
    score_mlp[i].{w,b}        score_mlp.{i}.weight (T), score_mlp.{i}.bias
    stacked_agg_w             stacked_feat_agg.weight
    embed_proj                embed_proj.weight (T)
    embed_layernorm           embed_layernorm.weight
    emb_mask_token            emb_mask_token

The 3D-molecule heads keep the JAX names (no HF name exists):

    denoise.{q,k,v}           denoise.{q,k,v}.weight (T)
    denoise.force_{w,b}       denoise.force_{w,b}
    embed_pos_type            embed_pos_type.weight
    embed_pos_token           embed_pos_token.weight
    embed_line_token          embed_line_token.weight
    embed_cube_token          embed_cube_token.weight
    smtp_proj, smtp_head      smtp_proj.weight, smtp_head.weight (T)
    pos_bins_proj, _head      pos_bins_proj.weight, pos_bins_head.weight (T)
    line_token_proj, _head    line_token_proj.weight, line_token_head.weight (T)
    cube_token_proj           cube_token_proj.weight (T)
    pos_token_agg_w           pos_token_agg_w

Arrays cross as numpy: the tree may hold numpy arrays or anything that
`np.asarray` reads. A key of the tree that this table does not name raises
(a head left out would otherwise keep its random init). A gradient tree, or
a tree of optimizer moments, has the weights' layout, so the same mapping
carries it (`tree_from_jax`).
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
# top-level matrices [in, out] -> nn.Linear weights [out, in]
_HEADS = (
    ("lm_head", "lm_head.weight"),
    ("n_token_proj", "n_token_proj.weight"),
    ("cl_proj", "cl_proj.weight"),
    ("smtp_proj", "smtp_proj.weight"),
    ("smtp_head", "smtp_head.weight"),
    ("pos_bins_proj", "pos_bins_proj.weight"),
    ("pos_bins_head", "pos_bins_head.weight"),
    ("line_token_proj", "line_token_proj.weight"),
    ("line_token_head", "line_token_head.weight"),
    ("cube_token_proj", "cube_token_proj.weight"),
    ("embed_proj", "embed_proj.weight"),
)
# top-level arrays kept as they are
_ASIS = (
    ("stacked_agg_w", "stacked_feat_agg.weight"),
    ("score_b", "score.bias"),
    ("embed_pos_type", "embed_pos_type.weight"),
    ("embed_pos_token", "embed_pos_token.weight"),
    ("embed_line_token", "embed_line_token.weight"),
    ("embed_cube_token", "embed_cube_token.weight"),
    ("pos_token_agg_w", "pos_token_agg_w"),
    ("embed_layernorm", "embed_layernorm.weight"),
    ("emb_mask_token", "emb_mask_token"),
)
# the denoise force head: (key, transposed)
_DENOISE = (("q", True), ("k", True), ("v", True), ("force_w", False), ("force_b", False))
_MAPPED = ({"embed_tokens", "final_norm", "layers", "score_w", "score_mlp", "denoise"}
           | {k for k, _ in _HEADS} | {k for k, _ in _ASIS})


def _denoise_name(key: str) -> str:
    return f"denoise.{key}.weight" if key in ("q", "k", "v") else f"denoise.{key}"


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """JAX params tree -> the port's fp32 state dict on `device` (cuda
    unless named). Raises on a key that the mapping does not name."""
    dev = resolve_device(device)
    layer_keys = {o for o, _ in _PROJ + _NORMS}
    unmapped = sorted(set(tree) - _MAPPED)
    unmapped += [f"layers.{k}" for k in sorted(set(tree.get("layers", {})) - layer_keys)]
    unmapped += [f"denoise.{k}" for k in sorted(set(tree.get("denoise", {}))
                                                - {o for o, _ in _DENOISE})]
    if unmapped:
        raise KeyError(f"params_from_jax: no mapping for {unmapped}")

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
    for ours, theirs in _ASIS:
        if ours in tree:
            sd[theirs] = t(tree[ours])
    if "score_w" in tree:
        sd["score.weight"] = t(np.asarray(tree["score_w"]).T)
    for i, layer in enumerate(tree.get("score_mlp", ())):
        sd[f"score_mlp.{i}.weight"] = t(np.asarray(layer["w"]).T)
        if "b" in layer:
            sd[f"score_mlp.{i}.bias"] = t(layer["b"])
    for key, transposed in _DENOISE:
        if key in tree.get("denoise", {}):
            x = np.asarray(tree["denoise"][key])
            sd[_denoise_name(key)] = t(x.T if transposed else x)
    return sd


def tree_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A JAX tree shaped like the params (gradients, Adam moments, an EMA
    copy) -> a dict by the port's parameter names."""
    return params_from_jax(tree, device)


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
    for ours, theirs in _ASIS:
        if theirs in sd:
            tree[ours] = a(sd[theirs])
    if "score.weight" in sd:
        tree["score_w"] = a(sd["score.weight"]).T
    if any(k.startswith("denoise.") for k in sd):
        tree["denoise"] = {
            key: a(sd[_denoise_name(key)]).T if transposed else a(sd[_denoise_name(key)])
            for key, transposed in _DENOISE
        }
    n_mlp = sum(1 for k in sd if k.startswith("score_mlp.") and k.endswith(".weight"))
    if n_mlp:
        tree["score_mlp"] = [
            {"w": a(sd[f"score_mlp.{i}.weight"]).T,
             **({"b": a(sd[f"score_mlp.{i}.bias"])} if f"score_mlp.{i}.bias" in sd else {})}
            for i in range(n_mlp)
        ]
    return tree
