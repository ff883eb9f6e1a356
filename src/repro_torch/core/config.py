"""Model configuration for the PyTorch port.

The port's own copy of the dataclasses and the architecture registry of
``repro.core.config``: the port imports nothing of the JAX package, so the
fields it reads are kept here with the same names and defaults, and so are
the optimizer and training configs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    """Multi-head attention description (GQA or MLA)."""

    kind: str = "gqa"  # "gqa" | "mla"
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 64
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # MLA (DeepSeek-V2) parameters; only read when kind == "mla".
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    """Token-choice top-k mixture-of-experts FFN."""

    num_experts: int = 8
    num_experts_per_tok: int = 2
    num_shared_experts: int = 0
    d_ff_expert: int = 512          # hidden dim of each routed expert
    d_ff_shared: int = 0            # hidden dim of the shared expert(s)
    moe_every: int = 1              # MoE FFN every k-th layer (others dense)
    moe_offset: int = 0             # phase of the MoE layers within the period
    first_k_dense: int = 0          # first k layers use a dense FFN
    d_ff_dense: int = 0             # dense-FFN hidden dim for non-MoE layers
    router_dtype: str = "float32"
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25   # <=0 means dropless (C = S*K)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective state-space block."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 => ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 ("Finch") time-mix / channel-mix block."""

    head_dim: int = 64
    decay_lora: int = 64            # rank of the data-dependent decay LoRA
    mix_lora: int = 32              # rank of the token-shift mix LoRA
    gate_lora: int = 64


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: precomputed embeddings fed to the backbone.

    ``input_specs`` produces ``(batch, num_prefix, d_model)`` embeddings; no
    vision/audio tower is instantiated (backbone only).
    """

    kind: str = "none"              # "none" | "patch" (vlm) | "frames" (audio)
    num_prefix: int = 0             # prefix embeddings per example


@dataclass(frozen=True)
class ConvLayerConfig:
    name: str
    kind: str                       # "conv" | "pool" | "dense" | "upsample"
    in_ch: int = 0
    out_ch: int = 0
    kernel: int = 3
    stride: int = 1
    dilation: int = 1
    # dense layers are 1x1 convs over the feature map in DilatedVGG-style nets


@dataclass(frozen=True)
class ConvNetConfig:
    layers: Tuple[ConvLayerConfig, ...] = ()
    in_hw: Tuple[int, int] = (1024, 2048)
    in_ch: int = 3
    num_classes: int = 19


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    num_layers: int = 2
    d_model: int = 128
    d_ff: int = 512
    vocab_size: int = 512
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    frontend: Optional[FrontendConfig] = None
    convnet: Optional[ConvNetConfig] = None
    attn_every: int = 0
    encoder_layers: int = 0
    act: str = "swiglu"             # "swiglu" | "gelu" | "relu2"
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    max_seq_len: int = 4096

    def layer_kinds(self) -> List[str]:
        """Per-layer mixer kind for hybrid models: 'attn' or 'ssm'."""
        if self.family != "hybrid" or not self.attn_every:
            if self.family == "ssm" and self.rwkv is not None:
                return ["rwkv"] * self.num_layers
            if self.family == "ssm":
                return ["ssm"] * self.num_layers
            return ["attn"] * self.num_layers
        return ["attn" if i % self.attn_every == self.attn_every // 2 else "ssm"
                for i in range(self.num_layers)]

    def ffn_kinds(self) -> List[str]:
        """Per-layer FFN kind: 'dense' or 'moe'."""
        if self.moe is None:
            return ["dense"] * self.num_layers
        kinds = []
        for i in range(self.num_layers):
            if i < self.moe.first_k_dense:
                kinds.append("dense")
            elif (i - self.moe.first_k_dense) % self.moe.moe_every \
                    == self.moe.moe_offset:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return kinds


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # "train" | "prefill" | "decode"


LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Train configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # "cosine" | "linear" | "constant"
    # distributed-optimization tricks
    grad_compression: str = "none"  # "none" | "int8_ef"
    grad_accum: int = 1


@dataclass(frozen=True)
class RematConfig:
    policy: str = "dots"            # "none" | "dots" | "full"


@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 4096
    global_batch: int = 256
    steps: int = 100
    seed: int = 0
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    remat: RematConfig = field(default_factory=RematConfig)
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    log_every: int = 10


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

_ARCH_REGISTRY: Dict[str, Callable[[], "ArchSpec"]] = {}


@dataclass(frozen=True)
class ArchSpec:
    """One architecture: full config + reduced smoke config + shapes."""

    arch_id: str
    model: ModelConfig
    smoke: ModelConfig
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: str = ""
    source: str = ""


def register_arch(arch_id: str):
    def deco(fn: Callable[[], ArchSpec]):
        _ARCH_REGISTRY[arch_id] = fn
        return fn

    return deco


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_configs_imported()
    if arch_id not in _ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_ARCH_REGISTRY)}"
        )
    return _ARCH_REGISTRY[arch_id]()


def list_archs() -> List[str]:
    _ensure_configs_imported()
    return sorted(_ARCH_REGISTRY)


def _ensure_configs_imported() -> None:
    # Importing repro_torch.configs registers every architecture module.
    import repro_torch.configs  # noqa: F401
