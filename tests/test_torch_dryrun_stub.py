"""Dry-run parity for the VLM (internvl2: a prefix of patch embeddings),
the enc-dec (seamless: encoder, decoder, cross-attention) and DilatedVGG
(convolutions, cuDNN on the card): the port's count of a step equals the
reference walker's, on fake CPU tensors and on ``meta``, but for the named
differences of ``_torch_dryrun_parity``.
"""
import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_dryrun_parity import B, check_cell, configs, port_count
from repro.core.hlo.analysis import analyze_compiled
from repro.models import api as japi
from repro_torch.core.cost.analysis import analyze_step
from repro_torch.launch.dryrun import empty_like_specs
from repro_torch.models import api as tapi


@pytest.mark.parametrize("arch,mode", [
    (arch, mode) for arch in ("internvl2-2b", "seamless-m4t-large-v2")
    for mode in ("train", "prefill", "decode")])
def test_count_equals_the_walker(monkeypatch, arch, mode):
    check_cell(monkeypatch, arch, mode)


def _walker_resize(jcfg) -> int:
    """The reference's x8 bilinear upscaling (``jax.image.resize``) alone:
    XLA computes it as products with interpolation weights, which the
    walker counts; ``F.interpolate`` computes it directly."""
    net = jcfg.convnet
    H, W = net.in_hw
    low = jax.ShapeDtypeStruct((B, H // 8, W // 8, net.num_classes),
                               "float32")
    return int(analyze_compiled(jax.jit(lambda x: jax.image.resize(
        x, (B, H, W, net.num_classes), "bilinear")).lower(low).compile())[
            "flops"])


def test_dilated_vgg_train_step_counts_each_convolution_three_times():
    """The smoke net (64 x 128) in f32: each convolution's backward counts
    its input's and its weight's gradients, each the forward's products, but
    the image's (no gradient).  The walker counts XLA's backward convolutions
    of the wide layers lower (at 64 x 128 x 64 channels, 2.5x the forward
    where the products are 3x), so the train step is held to its own
    forward here, which the test below holds to the walker."""
    _, tcfg = configs("dilated-vgg")
    rep = port_count(tcfg, "train", device="meta")
    fwd = rep["by_op"]["aten.convolution"]["flops"]
    first = tcfg.convnet.layers[0]
    H, W = tcfg.convnet.in_hw
    image_grad = 2 * B * H * W * first.out_ch * tcfg.convnet.in_ch \
        * first.kernel ** 2
    assert rep["by_op"]["aten.convolution_backward"]["flops"] \
        == 2 * fwd - image_grad
    assert rep["flops"] == 3 * fwd - image_grad
    with FakeTensorMode():
        assert port_count(tcfg, "train", device="cpu")["flops"] \
            == rep["flops"]


def test_dilated_vgg_forward_equals_the_walker():
    """Every convolution as the walker counts it, but the upscaling's
    products, which only the reference computes as products."""
    jcfg, tcfg = configs("dilated-vgg")
    batch = {"image": jax.ShapeDtypeStruct((B, *jcfg.convnet.in_hw,
                                            jcfg.convnet.in_ch), "float32")}
    walker = analyze_compiled(jax.jit(
        lambda p, b: japi.forward(p, jcfg, b)[0]).lower(
            japi.param_shapes(jcfg), batch).compile())["flops"] \
        - _walker_resize(jcfg)
    shape = (B, *tcfg.convnet.in_hw, tcfg.convnet.in_ch)
    counts = []
    for device in ("cpu", "meta"):
        with FakeTensorMode() if device == "cpu" else torch.no_grad():
            params = empty_like_specs(tapi.param_shapes(tcfg), device)
            image = torch.empty(shape, device=device)
            counts.append(analyze_step(
                lambda p, b: tapi.forward(p, tcfg, b)[0], params,
                {"image": image})["flops"])
    assert counts == [int(walker)] * 2
