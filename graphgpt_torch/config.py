"""Model and generation configs (the fields the inference path reads).

A copy of `graphgpt_tpu/config.py`'s `_MODEL_SIZES`, `ModelConfig` and
`GenerationConfig`, trimmed to what the port runs; `finalize` resolves the
derived fields the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# the reference's published architecture matrix
# (examples/graph_lvl/pcqm4m_v2_pretrain.sh:158-233 of the reference repo)
_MODEL_SIZES = {
    "tiny": dict(hidden_size=128, num_hidden_layers=2),
    "tiny6": dict(
        hidden_size=128, num_hidden_layers=6, intermediate_size=512,
        num_attention_heads=4, head_dim=32,
    ),
    "mini": dict(hidden_size=256, num_hidden_layers=4),
    "small": dict(hidden_size=512, num_hidden_layers=4),
    "small12": dict(
        hidden_size=384, num_hidden_layers=12, intermediate_size=384,
        num_attention_heads=12, head_dim=32,
    ),
    "medium": dict(hidden_size=512, num_hidden_layers=8),
    "base": dict(hidden_size=768, num_hidden_layers=12),
    "base24": dict(hidden_size=768, num_hidden_layers=24),
    "base48": dict(hidden_size=768, num_hidden_layers=48),
    "large": dict(hidden_size=1024, num_hidden_layers=24),
    "large48": dict(hidden_size=1024, num_hidden_layers=48),
    "xlarge": dict(hidden_size=1280, num_hidden_layers=36),
    "xlarge48": dict(hidden_size=1280, num_hidden_layers=48),
    "xxlarge": dict(hidden_size=1600, num_hidden_layers=48),
}


@dataclass
class ModelConfig:
    size: str = ""
    vocab_size: int = 0
    hidden_size: int = 128
    intermediate_size: int = 0  # 0 => 4*hidden
    num_hidden_layers: int = 2
    num_attention_heads: int = 0  # 0 => hidden//head_dim
    num_key_value_heads: int = 0  # 0 => num_attention_heads
    head_dim: int = 0  # 0 => 64
    hidden_act: str = "gelu"  # gelu|gelu_new|gelu_pytorch_tanh|silu
    max_position_embeddings: int = 1024
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_range: int = 0
    rope_resonance: bool = False
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    causal_attention: bool = False
    layer_scale_init_value: float = 0.0

    stacked_feat: int = 1
    stack_method: str = "short"  # short|long
    stacked_feat_agg_method: str = "sum"  # sum|gated
    embed_dim: int = 0  # raw-embedding branch: not in this port yet

    next_n_token: int = 1
    use_generative: bool = True
    focal_gamma: float = 0.0

    task_type: str = "pretrain-mlm"
    pad_token_id: int = 0
    mask_token_id: int = 0

    dtype: str = "bfloat16"  # activation dtype; weights stay fp32
    attn_block: int = 0
    bi_causal_split: int = 0

    def finalize(self) -> "ModelConfig":
        assert self.pad_token_id == 0, "pad_token_id is pinned to 0"
        if self.size:
            spec = _MODEL_SIZES[self.size]
            self.hidden_size = spec["hidden_size"]
            self.num_hidden_layers = spec["num_hidden_layers"]
            self.intermediate_size = spec.get("intermediate_size", self.intermediate_size)
            self.num_attention_heads = spec.get(
                "num_attention_heads", self.num_attention_heads
            )
            if "head_dim" in spec:
                self.head_dim = spec["head_dim"]
        if self.intermediate_size == 0:
            self.intermediate_size = self.hidden_size * 4
        if self.head_dim == 0:
            self.head_dim = 64
        if self.num_attention_heads == 0:
            assert self.hidden_size % self.head_dim == 0
            self.num_attention_heads = self.hidden_size // self.head_dim
        if self.num_key_value_heads == 0:
            self.num_key_value_heads = self.num_attention_heads
        if self.task_type in ("pretrain-mlm", "pretrain-mlm-coord"):
            self.causal_attention = False
        return self


@dataclass
class GenerationConfig:
    steps: int = 64
    alg: str = "entropy"  # origin|maskgit_plus|topk_margin|entropy
    temperature: float = 0.0
    top_p: float = 0.0  # 0 disables nucleus filtering
    top_k: int = 0  # 0 disables top-k filtering
    alg_temp: float = 0.0
    eps: float = 1e-3


def flagship_config(layers: int = 12) -> ModelConfig:
    """GraphGPT-base as the JAX package's `__graft_entry__.py` builds it: hidden 768,
    12 heads of 64, FFN 3072, stacked_feat and next_n 13 (PCQM4M-v2: 1 + 9
    node attrs + 3 edge attrs), vocab 754, mpe 1024, bidirectional SMTP,
    bf16 activations over fp32 weights. `layers` cuts the depth only."""
    return ModelConfig(
        vocab_size=754,
        hidden_size=768,
        num_hidden_layers=layers,
        stacked_feat=13,
        next_n_token=13,
        mask_token_id=1,
        task_type="pretrain-mlm",
        max_position_embeddings=1024,
        dtype="bfloat16",
    ).finalize()
