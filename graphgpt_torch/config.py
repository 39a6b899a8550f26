"""Tokenization, model, training and generation configs.

A copy of `graphgpt_tpu/config.py` (`_MODEL_SIZES`, the config groups,
`Config.sync`, `load_config` with `key.subkey=value` overrides), trimmed to
what the port runs: the mesh and the partitioned corpus wait for the
multi-GPU slice. `finalize` and `sync` resolve the derived fields the same
way. YAML is read only when `load_config` is given a file.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

TASK_TYPES = {
    "pretrain", "pretrain-mlm", "pretrain-smtp", "pretrain-cl", "pretrain-ltp",
    "pretrain-euler", "pretrain-coord", "pretrain-coord-cl", "pretrain-mlm-coord",
    "graph", "edge", "node", "nodev2",
}
PRETRAIN_TASKS = {t for t in TASK_TYPES if t.startswith("pretrain")}


# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------
@dataclass
class SemanticsAttrConfig:
    discrete: Optional[str] = None  # attr field name, e.g. "node_attr"
    dim: int = 0  # number of discrete columns
    continuous: Optional[str] = None
    ignored_val: Optional[int] = None
    embed: Optional[str] = None
    embed_dim: int = 0
    share_vocab: bool = False


@dataclass
class SemanticsConfig:
    attr_assignment: str = "first"
    node: SemanticsAttrConfig = field(default_factory=SemanticsAttrConfig)
    edge: SemanticsAttrConfig = field(default_factory=SemanticsAttrConfig)
    graph: SemanticsAttrConfig = field(default_factory=SemanticsAttrConfig)
    reserved_tokens: Tuple[str, ...] = tuple(f"semantics_{i}" for i in range(10))


@dataclass
class StructureNodeConfig:
    bos_token: str = "<bos>"
    eos_token: str = "<eos>"
    new_node_token: str = "<new>"
    node_scope: int = 512
    scope_base: int = 512
    cyclic: int = 1  # 0 normal / 1 cyclic / 2 random


@dataclass
class StructureEdgeConfig:
    remove_edge_type_token: bool = True
    in_token: str = "<edge_in>"
    out_token: str = "<edge_out>"
    bi_token: str = "<edge_bi>"
    jump_token: str = "<edge_jump>"


@dataclass
class StructureConfig:
    node: StructureNodeConfig = field(default_factory=StructureNodeConfig)
    edge: StructureEdgeConfig = field(default_factory=StructureEdgeConfig)
    summary_token: str = "<gsum>"
    mask_token: str = "<mask>"
    icl_token: str = "<icl>"
    sep_token: str = "<sep>"
    reserved_tokens: Tuple[str, ...] = tuple(f"structure_{i}" for i in range(10))


@dataclass
class TokenizationConfig:
    tokenizer_class: str = "StackedGSTTokenizer"
    dataset: str = "synthetic_mol"
    data_dir: str = "./data"
    vocab_file: str = "vocab"
    attr_world_identifier: str = "molecule"
    add_eos: bool = True  # the trailing eos row on task sequences
    stack_method: str = "short"  # short|long
    semantics: SemanticsConfig = field(default_factory=SemanticsConfig)
    structure: StructureConfig = field(default_factory=StructureConfig)
    # split-policy knobs applied by graph-level readers (reference
    # _readers/pcqm4mv2.py:344-428): true_valid, test_large,
    # remove_special {edge0,node1,node2,disconnected}, duplicate_train
    dataset_policy: Dict[str, Any] = field(default_factory=dict)

    @property
    def stacked_feat(self) -> int:
        """1 (short) or 2 (long) structural slots + attr dims."""
        base = 1 if self.stack_method == "short" else 2
        return base + self.semantics.node.dim + self.semantics.edge.dim

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

    # dropout trio + stochastic depth + layer scale
    attention_dropout: float = 0.0
    embed_dropout: float = 0.0
    mlp_dropout: float = 0.0
    path_dropout: float = 0.0  # DropPath max rate, linearly increasing per layer
    layer_scale_init_value: float = 0.0

    stacked_feat: int = 1
    stack_method: str = "short"  # short|long
    stacked_feat_agg_method: str = "sum"  # sum|gated
    embed_dim: int = 0  # raw-embedding branch: not in this port yet

    next_n_token: int = 1
    use_generative: bool = True
    use_discriminative: bool = False
    focal_gamma: float = 0.0
    smtp_inside: bool = False
    smtp_power: float = 1.0

    # 3D-position pretrain head (GraphGPTPosPred)
    pos_problem_type: str = "pos-smtp-line"  # pos-smtp-line|pos-smtp-cube|pos-smtp-mix
    pos_num_bins: int = 256  # line bins (or cube bins per axis)
    pos_num_bins_line: int = 256  # mix: line-token bins
    pos_num_bins_cube: int = 32  # mix: cube-token bins per axis
    smtp_3d_power: float = 1.0  # -1 cosine, -2 arccos, else polynomial
    smtp_3d_noise_scale: float = 0.2
    coord_lvl_mask: bool = True
    pos_agg_method: str = "sum"  # sum|gated for the 3-coord line tokens
    smtp_2d_rate: float = 0.1
    sep_2d3d_inputs: bool = True
    pos_range: str = "p1p"
    loss_agg: str = "token-lvl"  # token-lvl|sample-lvl

    # denoising double-heads fine-tune head (GraphGPTDenoise)
    noise_scale: float = 0.35
    denoise_wgt: float = 1.0
    denoise_schedule_pow: float = 0.0
    r_2d: float = 4.0
    r_3d: float = 0.0
    r_both: float = 6.0
    add_pos_type: bool = True
    smtp_3d: bool = False
    smtp_wgt: float = 1.0
    smtp_vocab: int = 256
    # label every valid position instead of only the schedule-masked ones
    smtp_denoise: bool = False

    # fine-tune head
    task_type: str = "pretrain-mlm"
    problem_type: str = ""  # regression|single_label_classification|multi_label_classification
    pooling_method: str = "last"  # last|mean|sum
    mlp: Tuple[int, ...] = ()  # hidden sizes of the score MLP (empty: one linear)
    head_dropout: float = 0.0
    loss_type: str = ""  # l1|mse|auc|token_ce|token_ce_intra|ce
    num_labels: int = 1
    num_neg: int = 1
    use_aux: bool = False  # auxiliary NTP head during fine-tuning

    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    mask_token_id: int = 0

    dtype: str = "bfloat16"  # activation dtype; weights stay fp32
    remat: bool = False  # activation rematerialisation per layer
    remat_policy: str = "full"  # full|pairs|quads|save_attn
    attn_block: int = 0
    bi_causal_split: int = 0  # >0: binary-energy decoding suffix length

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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
@dataclass
class MlmScheduleConfig:
    name: str = "polynomial"  # polynomial|cosine|fixed
    fixed_ratio: float = 0.7
    power: float = 1.0
    mtp: Tuple[float, float, float] = (1.0, 0.0, 0.0)  # mask/random/keep split
    umr_clip: Tuple[float, float] = (0.01, 0.99)
    dlm_wgt: bool = True
    num_gen_samples: int = 128


@dataclass
class ScheduleConfig:
    epochs: int = 0
    warmup_epochs: float = 0.0
    total_tokens: float = 1e9
    warmup_tokens: float = 1e8
    total_num_steps: int = 0
    warmup_num_steps: int = 0
    logging_steps: int = 100
    steps_per_saving: int = 0


@dataclass
class OptimizerConfig:
    name: str = "adamw"  # adamw|muon
    lr: float = 3e-4
    min_lr: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.95)
    weight_decay: float = 0.1
    eps: float = 1e-6
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    # warmup_decay|onecycle|cosine|constant|cyclic|cosine_wr|lr_range_test
    scheduler: str = "warmup_decay"
    cycle_steps: int = 0  # 0 => total_steps // 4
    cycle_mult: float = 1.0  # T_mult for cosine_wr
    use_ema: bool = False
    ema_decay: float = 0.9999
    # >0 engages layer-wise LR decay: layer i scaled by decay^(L-1-i)
    layerwise_lr_decay: float = 0.0


@dataclass
class TrainingConfig:
    output_dir: str = "./exp/run"
    pretrain_cpt: str = ""
    task_type: str = "pretrain-mlm"
    pretrain_mlm: MlmScheduleConfig = field(default_factory=MlmScheduleConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    batch_size: int = 128
    batch_size_eval: int = 0  # 0: batch_size
    max_length: int = 1024
    pad_to_multiple_of: int = 8
    pack_tokens: float = 0.0  # > 0: pack samples into rows of max_length
    # block-aligned packing window (0 = off): no sample crosses a pack_block
    # boundary, so attention may run at P = pack_block (ModelConfig.attn_block)
    pack_block: int = 0
    # SMTP masking drawn once per packed row instead of per sample
    mask_after_pack: bool = False
    num_workers: int = 8
    valid_percent: float = 0.0
    do_valid: bool = False
    # pretraining's save-point generation sweep: bands of the unmask ratio
    # (0: none) over the first gen_eval_samples valid graphs
    gen_eval_bands: int = 4
    gen_eval_samples: int = 32
    do_test: bool = True  # evaluate the test split each eval epoch
    inspect_tokenization: bool = True  # one sample's rows and length percentiles at setup
    seed: int = 42
    tot_samples: int = 10000  # caps the samples of the tokens-per-sample estimate
    freeze: int = -1  # >= 0: freeze the embeddings and the first `freeze` layers
    epoch_per_eval: int = 1
    eval_only: bool = False
    k_samplers: int = 256  # train-subset eval size
    save_pred: bool = False  # dump per-split prediction csv at each eval
    dump_infer: bool = False  # dump test pooled hidden states
    use_tb_writer: bool = False  # TensorBoard event files: not in the port yet


@dataclass
class GenerationConfig:
    steps: int = 64
    alg: str = "entropy"  # origin|maskgit_plus|topk_margin|entropy
    temperature: float = 0.0
    top_p: float = 0.0  # 0 disables nucleus filtering
    top_k: int = 0  # 0 disables top-k filtering
    alg_temp: float = 0.0
    eps: float = 1e-3
    batched: bool = True  # False: the sampler runs one example at a time


def flagship_config(layers: int = 12) -> ModelConfig:
    """GraphGPT-base as the JAX package's `__graft_entry__.py` builds it: hidden 768,
    12 heads of 64, FFN 3072, stacked_feat and next_n 13 (PCQM4M-v2: 1 + 9
    node attrs + 3 edge attrs), vocab 754, mpe 1024, bidirectional SMTP,
    bf16 activations over fp32 weights, per-layer rematerialisation that
    keeps the attention outputs. `layers` cuts the depth only."""
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
        remat=True,
        remat_policy="save_attn",
    ).finalize()


# ---------------------------------------------------------------------------
# The composed config, dicts, YAML and overrides
# ---------------------------------------------------------------------------
@dataclass
class Config:
    tokenization: TokenizationConfig = field(default_factory=TokenizationConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)

    def sync(self) -> "Config":
        """Propagate the cross-group derived fields."""
        tok, m = self.tokenization, self.model
        m.task_type = self.training.task_type
        m.stack_method = tok.stack_method
        m.stacked_feat = 1 if tok.tokenizer_class == "GSTTokenizer" else tok.stacked_feat
        m.next_n_token = m.stacked_feat if self.training.task_type in PRETRAIN_TASKS else 1
        m.embed_dim = tok.semantics.node.embed_dim + tok.semantics.edge.embed_dim
        m.max_position_embeddings = max(m.max_position_embeddings, self.training.max_length)
        m.finalize()
        return self


def _from_dict(cls, data: Dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in data.items():
        if key not in fields:
            raise KeyError(f"Unknown config key {key!r} for {cls.__name__}")
        f = fields[key]
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else None
        if isinstance(val, dict) and dataclasses.is_dataclass(default):
            kwargs[key] = _from_dict(type(default), val)
        elif isinstance(val, list):
            kwargs[key] = tuple(val)
        elif isinstance(f.default, float) and isinstance(val, str):
            # YAML 1.1 reads an exponent without a sign (2.0e11) as a string
            kwargs[key] = float(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


def config_from_dict(data: Dict[str, Any]) -> Config:
    return _from_dict(Config, data)


def config_to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except ValueError:
        return raw


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply `group.key.subkey=value` overrides in place."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override {item!r} must be key=value")
        path, raw = item.split("=", 1)
        parts = path.split(".")
        obj = cfg
        for part in parts[:-1]:
            obj = getattr(obj, part)
        if not hasattr(obj, parts[-1]):
            raise AttributeError(
                f"Unknown config key {path!r} ({type(obj).__name__} has no field {parts[-1]!r})"
            )
        val = _parse_value(raw)
        setattr(obj, parts[-1], tuple(val) if isinstance(val, list) else val)
    return cfg


def load_config(yaml_path: Optional[str] = None, overrides: Optional[List[str]] = None) -> Config:
    if yaml_path:
        import yaml  # only for a config file

        with open(yaml_path) as f:
            cfg = config_from_dict(yaml.safe_load(f) or {})
    else:
        cfg = Config()
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg.sync()
