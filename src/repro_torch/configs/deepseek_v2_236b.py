"""deepseek-v2-236b [arXiv:2405.04434; hf].

60L d_model=5120 128H MLA (kv_lora=512) d_ff=1536/expert vocab=102400,
MoE 2 shared + 160 routed top-6; first layer dense (d_ff 12288).

``CARD`` is the configuration served on one 80 GB card: ``FULL`` with one key
changed, ``num_layers`` 60 -> 4, left in bf16 and not registered.  Layer 0
is MLA with the dense SwiGLU FFN (d_ff_dense 12288), layers 1-3 MLA with the
MoE FFN (160 routed experts top-6 of d_ff 1536, 2 shared experts of 3072),
so the stack has its dense prefix block and three stacked periods, every
kind of layer at every published width: 128 heads, q_lora_rank 1536,
kv_lora_rank 512, nope 128, rope 64, v 128, vocab 102400.  Its weights come
to about 13.3 B parameters, 26.6 GB in bf16 (embedding and untied head
1.05 B, MLA 149 M a layer, the dense FFN 189 M, an MoE FFN 3.82 B).  What is
lost is the depth: 4 of 60 layers.

``TRAIN_CARD`` is the configuration trained on one 80 GB card: ``FULL`` cut
to its first layer (MLA and the dense SwiGLU FFN of d_ff 12288) at every
published width, not registered.  Its weights come to 1,386,562,560
parameters: embedding and untied head 1.049 B, MLA 149 M, the dense FFN
189 M; in bf16 with AdamW's f32 moments about 16.6 GB (params 2.8 GB,
gradients 2.8 GB, moments 11.1 GB) before activations.  Two layers (the
dense one and an MoE layer) come to 5.36 B parameters, about 64 GB before
any activation, so they do not train with margin on one card.  What is
lost is the MoE layers (the MoE FFN trains at smoke size only) and the
depth: 1 of 60 layers.
"""
from dataclasses import replace

from repro_torch.core.config import (ArchSpec, AttentionConfig, MoEConfig,
                                     ModelConfig, register_arch)

FULL = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    d_ff=12288,
    vocab_size=102_400,
    attention=AttentionConfig(
        kind="mla", num_heads=128, num_kv_heads=128, head_dim=128,
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        rope_theta=10_000.0),
    moe=MoEConfig(num_experts=160, num_experts_per_tok=6,
                  num_shared_experts=2, d_ff_expert=1536, d_ff_shared=3072,
                  first_k_dense=1, d_ff_dense=12288),
    act="swiglu",
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    attention=AttentionConfig(
        kind="mla", num_heads=4, num_kv_heads=4, head_dim=32,
        q_lora_rank=32, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, num_experts_per_tok=2,
                  num_shared_experts=1, d_ff_expert=32, d_ff_shared=32,
                  first_k_dense=1, d_ff_dense=128),
    act="swiglu",
)

# the first 4 layers at full width, bf16: what one 80 GB card serves
CARD = replace(FULL, num_layers=4)
# the first layer at full width: what one 80 GB card trains
TRAIN_CARD = replace(FULL, num_layers=1)


@register_arch("deepseek-v2-236b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="deepseek-v2-236b",
        model=FULL,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_shapes=("long_500k",),
        skip_reason="MLA compresses the cache but attention is still full "
                    "(quadratic); long_500k skipped per assignment rule",
        source="arXiv:2405.04434",
    )
