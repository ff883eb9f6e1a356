"""Architecture configs the port runs.  Importing this package registers
each of them with repro_torch.core.config's registry (``--arch <id>``)."""
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    dilated_vgg,
    granite_moe_1b_a400m,
    internvl2_2b,
    jamba_1_5_large_398b,
    minitron_8b,
    mistral_large_123b,
    qwen1_5_0_5b,
    qwen2_5_14b,
    rwkv6_1_6b,
    seamless_m4t_large_v2,
)
