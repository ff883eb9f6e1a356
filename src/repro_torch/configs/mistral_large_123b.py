"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.

``FULL`` has 122,610,069,504 parameters (245 GB in bf16): each layer
1,384,144,896, the embedding, the untied head and the final norm
805,318,656.  It does not fit one 80 GB card.

``CARD`` is the configuration served on one 80 GB card: ``FULL`` with one
key changed, ``num_layers`` 88 -> 16, left in bf16 and not registered.  Its
weights come to 22,951,636,992 parameters, 45.9 GB.  Every layer is the
same dense GQA layer, so each runs at every published width (96/8 heads of
128, d_ff 28672 SwiGLU, vocab 32768, rope_theta 1e6); what is lost is the
depth alone.
"""
from dataclasses import replace

from repro_torch.core.config import (ArchSpec, AttentionConfig, ModelConfig,
                                     register_arch)

FULL = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    d_ff=28_672,
    vocab_size=32_768,
    attention=AttentionConfig(kind="gqa", num_heads=96, num_kv_heads=8,
                              head_dim=128, rope_theta=1_000_000.0),
    act="swiglu",
)

SMOKE = ModelConfig(
    name="mistral-large-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                              head_dim=16),
    act="swiglu",
)

# the first 16 layers at full width, bf16: what one 80 GB card serves
CARD = replace(FULL, num_layers=16)


@register_arch("mistral-large-123b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="mistral-large-123b",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch (assignment rule)",
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )
