"""jamba-1.5-large-398b [arXiv:2403.19887; hf].

72L d_model=8192; Mamba:attention 7:1 interleave (one attention layer per
8, at offset 4), MoE 16e top-2 on every 2nd layer (offset 1); GQA kv=8,
d_ff=24576; vocab=65536.  398B total / ~94B active.

``CARD`` is the configuration served on one 80 GB card: ``FULL`` with one key
changed, ``num_layers`` 72 -> 5, left in bf16 and not registered.  Its
weights come to about 24.05 B parameters, 48 GB in bf16 (embedding and
untied head 1.07 B, four Mamba mixers of 420 M, attention 0.15 B, three dense
FFNs 1.81 B, two MoE FFNs 9.66 B each); one whole period of 8 layers (about
39 B, 78 GB) does not fit.  Layers 0-4 are Mamba+dense, Mamba+MoE,
Mamba+dense, Mamba+MoE and attention+dense, so every kind of layer runs at
every published width: 16 experts top-2 of d_ff 24576, GQA 64/8 heads of
128, d_state 16, d_conv 4, expand 2, vocab 65536.  What is lost is the
Mamba:attention ratio, 4:1 in ``CARD`` against the published 7:1, and the
depth.
"""
from dataclasses import replace

from repro_torch.core.config import (ArchSpec, AttentionConfig, MoEConfig,
                                     ModelConfig, SSMConfig, register_arch)

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    d_ff=24_576,
    vocab_size=65_536,
    attention=AttentionConfig(kind="gqa", num_heads=64, num_kv_heads=8,
                              head_dim=128),
    moe=MoEConfig(num_experts=16, num_experts_per_tok=2, d_ff_expert=24_576,
                  moe_every=2, moe_offset=1, d_ff_dense=24_576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    act="swiglu",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,                      # one full period: attn@4, MoE on odds
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                              head_dim=16),
    moe=MoEConfig(num_experts=4, num_experts_per_tok=2, d_ff_expert=128,
                  moe_every=2, moe_offset=1, d_ff_dense=128),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    attn_every=8,
    act="swiglu",
)

# the first 5 layers at full width, bf16: what one 80 GB card holds
CARD = replace(FULL, num_layers=5)


@register_arch("jamba-1.5-large-398b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="jamba-1.5-large-398b",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        source="arXiv:2403.19887",
    )
