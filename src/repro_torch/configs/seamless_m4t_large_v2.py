"""seamless-m4t-large-v2 [arXiv:2308.11596; hf] — encoder-decoder, audio.

24L (encoder) + 24L (decoder) d_model=1024 16H (kv=16) d_ff=8192
vocab=256206.  The speech frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings to the encoder (backbone only).  Shape cells
split seq_len as S/2 encoder frames + S/2 decoder tokens.
"""
from repro_torch.core.config import (ArchSpec, AttentionConfig,
                                     FrontendConfig, ModelConfig,
                                     register_arch)

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    d_ff=8192,
    vocab_size=256_206,
    attention=AttentionConfig(kind="gqa", num_heads=16, num_kv_heads=16,
                              head_dim=64),
    frontend=FrontendConfig(kind="frames", num_prefix=0),
    act="gelu",
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=4,
                              head_dim=16),
    frontend=FrontendConfig(kind="frames", num_prefix=0),
    act="gelu",
    norm="layernorm",
)


@register_arch("seamless-m4t-large-v2")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="seamless-m4t-large-v2",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_shapes=("long_500k",),
        skip_reason="full-attention enc-dec (assignment rule)",
        source="arXiv:2308.11596",
    )
