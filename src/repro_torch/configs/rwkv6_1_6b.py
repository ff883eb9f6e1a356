"""rwkv6-1.6b "Finch" [arXiv:2404.05892; unverified].

24L d_model=2048 attention-free (data-dependent decay) d_ff=7168 vocab=65536.
"""
from repro_torch.core.config import (ArchSpec, ModelConfig, RWKVConfig,
                                     register_arch)

FULL = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65_536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    rwkv=RWKVConfig(head_dim=16, decay_lora=8, mix_lora=8),
    norm="layernorm",
)


@register_arch("rwkv6-1.6b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="rwkv6-1.6b",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        source="arXiv:2404.05892",
    )
