"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (GQA kv=16 = MHA) d_ff=2816 vocab=151936, QKV bias,
tied embeddings.
"""
from repro_torch.core.config import (ArchSpec, AttentionConfig,
                                     ModelConfig, register_arch)

FULL = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    d_ff=2816,
    vocab_size=151_936,
    attention=AttentionConfig(kind="gqa", num_heads=16, num_kv_heads=16,
                              head_dim=64, qkv_bias=True),
    act="swiglu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=4,
                              head_dim=16, qkv_bias=True),
    act="swiglu",
    tie_embeddings=True,
)


@register_arch("qwen1.5-0.5b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen1.5-0.5b",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch (assignment rule)",
        source="hf:Qwen/Qwen1.5-0.5B",
    )
