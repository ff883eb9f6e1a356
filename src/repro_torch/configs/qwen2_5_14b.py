"""qwen2.5-14b [hf:Qwen/Qwen2.5 family; hf].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias.

``FULL`` is served whole on one 80 GB card, in bf16: 14,770,033,664
parameters (each layer 275,268,608; the embedding, the untied head and
the final norm 1,557,140,480), 29.5 GB.
"""
from repro_torch.core.config import (ArchSpec, AttentionConfig, ModelConfig,
                                     register_arch)

FULL = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    d_ff=13_824,
    vocab_size=152_064,
    attention=AttentionConfig(kind="gqa", num_heads=40, num_kv_heads=8,
                              head_dim=128, qkv_bias=True,
                              rope_theta=1_000_000.0),
    act="swiglu",
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                              head_dim=16, qkv_bias=True),
    act="swiglu",
)


@register_arch("qwen2.5-14b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen2.5-14b",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch (assignment rule)",
        source="hf:Qwen/Qwen2.5-14B",
    )
