"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
"""
from repro_torch.core.config import (ArchSpec, AttentionConfig, MoEConfig,
                                     ModelConfig, register_arch)

FULL = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    d_ff=512,
    vocab_size=49155,
    attention=AttentionConfig(kind="gqa", num_heads=16, num_kv_heads=8,
                              head_dim=64, rope_theta=10_000.0),
    moe=MoEConfig(num_experts=32, num_experts_per_tok=8, d_ff_expert=512),
    act="swiglu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    d_ff=64,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                              head_dim=16),
    moe=MoEConfig(num_experts=4, num_experts_per_tok=2, d_ff_expert=64),
    act="swiglu",
    tie_embeddings=True,
)


@register_arch("granite-moe-1b-a400m")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="granite-moe-1b-a400m",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch: long_500k needs sub-quadratic "
                    "attention (assignment rule)",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
