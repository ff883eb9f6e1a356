"""minitron-8b (pruned Nemotron-4) [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000; squared-ReLU FFN
(Nemotron family), untied embeddings.
"""
from repro_torch.core.config import (ArchSpec, AttentionConfig,
                                     ModelConfig, register_arch)

FULL = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=16_384,
    vocab_size=256_000,
    attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=8,
                              head_dim=128, rope_theta=10_000.0),
    act="relu2",
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=256,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                              head_dim=16),
    act="relu2",
    norm="layernorm",
)


@register_arch("minitron-8b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="minitron-8b",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch (assignment rule)",
        source="arXiv:2407.14679",
    )
