"""DilatedVGG — the paper's evaluation workload (Yu & Koltun 2015 [6],
'slightly modified' per the paper).  VGG-16 front end with dilation in the
later stages instead of pooling, a Dense1 1x1 stage and bilinear Upscaling —
layer names follow the paper's Figures 5-7 (conv1_1 ... conv4_5, Dense1,
Upscaling).
"""
from repro_torch.core.config import (ArchSpec, ConvLayerConfig as C,
                                     ConvNetConfig, ModelConfig,
                                     register_arch)


def _layers():
    # (name, kind, in_ch, out_ch, kernel, stride, dilation)
    spec = [
        ("conv1_0", "conv", 3, 64, 3, 1, 1),
        ("conv1_1", "conv", 64, 64, 3, 1, 1),
        ("pool1", "pool", 64, 64, 2, 2, 1),
        ("conv2_0", "conv", 64, 128, 3, 1, 1),
        ("conv2_1", "conv", 128, 128, 3, 1, 1),
        ("pool2", "pool", 128, 128, 2, 2, 1),
        ("conv3_0", "conv", 128, 256, 3, 1, 1),
        ("conv3_1", "conv", 256, 256, 3, 1, 1),
        ("conv3_2", "conv", 256, 256, 3, 1, 1),
        ("pool3", "pool", 256, 256, 2, 2, 1),
        # dilated stage: pooling removed, dilation grows (paper's Conv4_0-4_5)
        ("conv4_0", "conv", 256, 512, 3, 1, 1),
        ("conv4_1", "conv", 512, 512, 3, 1, 1),
        ("conv4_2", "conv", 512, 512, 3, 1, 2),
        ("conv4_3", "conv", 512, 512, 3, 1, 2),
        ("conv4_4", "conv", 512, 512, 3, 1, 4),
        ("conv4_5", "conv", 512, 512, 3, 1, 4),
        ("dense1", "dense", 512, 1024, 1, 1, 1),
        ("dense2", "dense", 1024, 19, 1, 1, 1),
        ("upscaling", "upsample", 19, 19, 8, 8, 1),
    ]
    return tuple(C(name=n, kind=k, in_ch=i, out_ch=o, kernel=ks, stride=s,
                   dilation=d) for n, k, i, o, ks, s, d in spec)


FULL = ModelConfig(
    name="dilated-vgg",
    family="convnet",
    convnet=ConvNetConfig(layers=_layers(), in_hw=(1024, 2048), in_ch=3,
                          num_classes=19),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="dilated-vgg-smoke",
    family="convnet",
    convnet=ConvNetConfig(layers=_layers(), in_hw=(64, 128), in_ch=3,
                          num_classes=19),
)


@register_arch("dilated-vgg")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dilated-vgg",
        model=FULL,
        smoke=SMOKE,
        shapes=(),          # paper-validation workload, not an LM cell
        source="arXiv:1511.07122 via the paper's FPGA prototype [4]",
    )
