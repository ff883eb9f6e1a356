"""internvl2-2b [arXiv:2404.16821; hf] — InternViT + InternLM2 backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The InternViT
frontend is a STUB: ``input_specs`` provides precomputed patch embeddings
(1024 prefix positions); only the LM backbone runs.
"""
from repro_torch.core.config import (ArchSpec, AttentionConfig,
                                     FrontendConfig, ModelConfig,
                                     register_arch)

FULL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92_553,
    attention=AttentionConfig(kind="gqa", num_heads=16, num_kv_heads=8,
                              head_dim=128, rope_theta=1_000_000.0),
    frontend=FrontendConfig(kind="patch", num_prefix=1024),
    act="swiglu",
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                              head_dim=16),
    frontend=FrontendConfig(kind="patch", num_prefix=8),
    act="swiglu",
)


@register_arch("internvl2-2b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="internvl2-2b",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch (assignment rule)",
        source="arXiv:2404.16821",
    )
