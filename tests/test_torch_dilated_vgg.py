"""Port parity for DilatedVGG: repro_torch.models.dilated_vgg against
repro.models.dilated_vgg, and the api's input specs and model FLOPs.

The JAX params (``api.init_params``; biases drawn from a seed where a test
says so, since the init's are zero) are converted key for key; images and
labels come from seeded NumPy.  The f32 forward is held to 1e-4 (the
reference's own bound is 2e-3, ``tests/test_models.py``) at the smoke size
and at an odd 36 x 50, whose pools pad (18 x 25 -> 9 x 13 -> 5 x 7).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core.config import get_arch as jax_get_arch
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import dilated_vgg as jdvgg
from repro.optim import adamw as jadamw
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import dilated_vgg as tdvgg
from repro_torch.optim import adamw as tadamw

ARCH = "dilated-vgg"
ATOL = 1e-4
GRAD_REL = 1e-4       # of each gradient leaf's largest element


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _at(cfg, hw):
    return dataclasses.replace(cfg, convnet=dataclasses.replace(
        cfg.convnet, in_hw=hw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree):
    return dict(tadamw.named_leaves(tree))


def _image(hw, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch,) + hw + (3,)).astype(np.float32)


def _labels(hw, seed=1, batch=2):
    return np.random.default_rng(seed).integers(
        0, 19, (batch,) + hw).astype(np.int32)


def _jit_init(cfg, seed):
    return jax.jit(lambda k: japi.init_params(k, cfg))(jax.random.key(seed))


def _jit_forward(cfg):
    return jax.jit(lambda p, x: japi.forward(p, cfg, {"image": x})[0])


@pytest.fixture(scope="module")
def jax_init():
    """JAX's init of the smoke config in f32 (its 15 M params are drawn
    once: the draw takes seconds).  JAX's bf16 init is this tree cast to
    bf16: it draws in f32 and casts."""
    return _jit_init(_f32(jax_get_arch(ARCH).smoke), 1)


class F32:
    """The smoke config in f32: JAX params with biases from a seed, their
    port twin, and the JAX forward jitted once."""

    def __init__(self, jp):
        self.cfg = _f32(jax_get_arch(ARCH).smoke)
        self.tcfg = _f32(tconfig.get_arch(ARCH).smoke)
        rng = np.random.default_rng(2)
        self.np_params = {
            name: {"w": np.asarray(leaf["w"]),
                   "b": (0.1 * rng.standard_normal(leaf["b"].shape)
                         ).astype(np.float32)}
            for name, leaf in jp.items()}
        self.jp = jax.tree.map(jnp.asarray, self.np_params)
        self.j_forward = _jit_forward(self.cfg)

    def tparams(self):
        return params_from_jax(self.np_params, "cpu")


@pytest.fixture(scope="module")
def f32(jax_init):
    return F32(jax_init)


# ---------------------------------------------------------------------------
# Config and params
# ---------------------------------------------------------------------------


def test_params_convert_key_for_key(jax_init):
    """JAX's tree converts leaf for leaf; the port's own init builds the
    same keys, shapes and dtypes, bf16 as the configs declare; param counts
    are JAX's at both sizes."""
    j, t = jax_get_arch(ARCH), tconfig.get_arch(ARCH)
    for jc, tc in ((j.smoke, t.smoke), (j.model, t.model)):
        jshapes = _named(jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), japi.param_shapes(jc),
            is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
        tshapes = {path: (spec.shape, str(spec.dtype).split(".")[-1])
                   for path, spec in _named(tapi.param_shapes(tc)).items()}
        assert tshapes == jshapes
        assert tapi.param_count(tc) == japi.param_count(jc)
    assert tapi.param_count(t.model) == 15_259_475
    jp = _np_tree(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jax_init))
    tp = params_from_jax(jp, "cpu")
    own = tapi.init_params(torch.Generator().manual_seed(0), t.smoke)
    for tree in (tp, own):
        assert {p: (tuple(x.shape), x.dtype) for p, x in _named(tree).items()} \
            == {p: (tuple(x.shape), torch.bfloat16)
                for p, x in _named(tp).items()}
    for path, leaf in _named(tp).items():
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      _named(jp)[path].astype(np.float32))
    # the port's init draws He-scaled weights and zero biases, as JAX's does
    w = own["conv4_1"]["w"].float()
    assert abs(w.std().item() - (2.0 / (9 * 512)) ** 0.5) < 1e-3
    assert not any(own[n]["b"].any() for n in own)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,out_hw", [((64, 128), (64, 128)),
                                       ((36, 50), (40, 56))])
def test_forward_f32_matches_jax(f32, hw, out_hw):
    x = _image(hw)
    want = np.asarray(f32.j_forward(f32.jp, jnp.asarray(x)))
    got, aux = tapi.forward(f32.tparams(), _at(f32.tcfg, hw),
                            {"image": torch.from_numpy(x)})
    assert got.shape == (2,) + out_hw + (19,) == want.shape
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert np.abs(want).max() > 0.5            # the logits are not all zero
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_forward_bf16_matches_jax(jax_init):
    """The config's own bf16, from JAX's bf16 params: within 1e-2 relative
    RMS of JAX's bf16 logits (bf16 rounds each layer's output)."""
    cfg = jax_get_arch(ARCH).smoke
    assert cfg.compute_dtype == cfg.param_dtype == "bfloat16"
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jax_init)
    x = _image((64, 128), seed=4)
    want = np.asarray(_jit_forward(cfg)(jp, jnp.asarray(x))).astype(
        np.float32)
    got, _ = tapi.forward(params_from_jax(_np_tree(jp), "cpu"),
                          tconfig.get_arch(ARCH).smoke,
                          {"image": torch.from_numpy(x)})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-2, rel


# ---------------------------------------------------------------------------
# SAME padding, pooling and resizing against XLA's ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,kernel,stride,dilation", [
    ((8, 10), 3, 2, 1),        # stride 2, even sizes: pads (0, 1)
    ((9, 11), 3, 2, 1),        # stride 2, odd sizes: pads (1, 1)
    ((9, 10), 3, 1, 2),        # dilation 2: pads (2, 2)
    ((10, 7), 3, 2, 2),        # stride and dilation: (1, 2) and (2, 2)
    ((8, 9), 2, 1, 1),         # even kernel: (0, 1)
    ((7, 8), 1, 2, 1),         # 1 x 1, stride 2: no padding
])
def test_conv_same_padding_matches_xla(hw, kernel, stride, dilation):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2,) + hw + (3,)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 3, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    want = np.asarray(jdvgg._conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), stride, dilation))
    got = tdvgg._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(w), torch.from_numpy(b), stride,
                      dilation).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,kernel,stride", [
    ((8, 10), 3, 2),           # k != s, even: pads (0, 1)
    ((9, 11), 3, 2),           # k != s, odd: pads (1, 1)
    ((9, 13), 2, 2),           # the net's pools at odd sizes: (0, 1)
    ((7, 6), 3, 1),            # stride 1: (1, 1)
])
def test_pool_same_padding_matches_reduce_window(hw, kernel, stride):
    x = np.random.default_rng(6).standard_normal(
        (2,) + hw + (3,)).astype(np.float32) - 3.0      # all negative
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, kernel, kernel, 1),
        (1, stride, stride, 1), "SAME"))
    lay = tconfig.ConvLayerConfig("pool", "pool", 3, 3, kernel, stride)
    got = tdvgg.apply_layer({}, lay, torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upscaling_matches_image_resize(dtype):
    """Bilinear x8 as ``jax.image.resize``: half-pixel centres, edges
    clamped."""
    x = np.random.default_rng(7).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax.image.resize(jx, (2, 40, 56, 3), "bilinear")
                      .astype(dtype)).astype(np.float32)
    lay = tconfig.ConvLayerConfig("upscaling", "upsample", 3, 3, 8, 8)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tdvgg.apply_layer({}, lay, tx.permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).float().numpy()
    # bf16: one ulp at the inputs' largest magnitude (each output is a
    # convex combination of inputs; the two round at different points)
    tol = 1e-6 if dtype == "float32" else \
        2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("n,kernel,stride,dilation,pads", [
    (1024, 3, 1, 1, (1, 1)), (128, 3, 1, 4, (4, 4)), (9, 2, 2, 1, (0, 1)),
    (8, 3, 2, 1, (0, 1)), (9, 3, 2, 1, (1, 1)), (5, 1, 1, 1, (0, 0)),
    (3, 7, 1, 1, (3, 3)),
])
def test_same_pads(n, kernel, stride, dilation, pads):
    assert tdvgg.same_pads(n, kernel, stride, dilation) == pads


# ---------------------------------------------------------------------------
# Loss, gradients and the train step
# ---------------------------------------------------------------------------


def _torch_loss_and_grads(cfg, params, batch):
    named = tadamw.named_leaves(params)
    alias = {p: t.detach().requires_grad_() for p, t in named}
    loss, metrics = tapi.loss_fn(tadamw.tree_like(params, alias), cfg, batch,
                                 remat="none")
    grads = torch.autograd.grad(loss, [alias[p] for p, _ in named])
    return loss, metrics, {p: g for (p, _), g in zip(named, grads)}


# the odd size, whose pools pad; its logits come out at 40 x 56, and the
# labels are given at that size
ODD, ODD_OUT = (36, 50), (40, 56)


def _odd_batch():
    return _image(ODD, seed=9), _labels(ODD_OUT, seed=10)


def _relu_flips(np_params, cfg, x) -> int:
    """Pre-activations that the port's f32 layers put on the other side of
    relu's kink from the same layers in f64.  The gradient jumps there: at
    such an element two correct f32 evaluations may disagree by a whole
    pixel's share of a leaf's gradient, far beyond 1e-4 of it where a layer
    has 5 x 7 pixels an image."""
    flips = 0
    h = {dt: torch.from_numpy(x).to(dt).permute(0, 3, 1, 2)
         for dt in (torch.float32, torch.float64)}
    p = {dt: params_from_jax(np_params, "cpu", dt) for dt in h}
    for lay in cfg.convnet.layers:
        if lay.kind in ("conv", "dense"):
            z = {dt: tdvgg._conv(h[dt], p[dt][lay.name]["w"],
                                 p[dt][lay.name]["b"], lay.stride,
                                 lay.dilation) for dt in h}
            flips += int(((z[torch.float32] > 0)
                          != (z[torch.float64] > 0)).sum())
            h = {dt: torch.relu(z[dt]) for dt in h}
        else:
            h = {dt: tdvgg.apply_layer({}, lay, h[dt]) for dt in h}
    return flips


def test_loss_and_grads_match_jax(f32):
    """The loss and every gradient leaf within 1e-4 of the leaf's largest,
    at an input whose relu pattern the port's f32 forward shares with f64
    (``_relu_flips``)."""
    x, y = _odd_batch()
    assert _relu_flips(f32.np_params, f32.tcfg, x) == 0
    cfg = _at(f32.cfg, ODD)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, cfg, b), has_aux=True))(
        f32.jp, {"image": jnp.asarray(x), "labels": jnp.asarray(y)})
    loss, metrics, grads = _torch_loss_and_grads(
        _at(f32.tcfg, ODD), f32.tparams(),
        {"image": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    assert set(metrics) == set(jmet) == {"loss", "aux", "total"}
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jmet[key]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jnamed = _named(_np_tree(jgrads))
    assert jnamed.keys() == grads.keys()
    for path, g in grads.items():
        scale = np.abs(jnamed[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), jnamed[path],
                                   atol=GRAD_REL * scale, rtol=0,
                                   err_msg=path)


def test_train_step_matches_jax(f32):
    """One step of each package's ``make_train_step`` (the port's passes
    ``remat=``, which the convnet ignores as the reference's does) from the
    same params and batch.  The metrics agree, and so do ``m`` and ``v`` (0.1
    times the clipped gradient, 0.05 times its square) to 1e-4 of each
    leaf's largest.  Adam's first step moves each element by about lr
    whatever its gradient's size, so the params after the step are held to
    JAX's AdamW on the port's own gradient (1e-6) and, as
    tests/test_torch_train.py holds them, to JAX's whole step (2e-3)."""
    x, y = _odd_batch()
    assert _relu_flips(f32.np_params, f32.tcfg, x) == 0
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jopt, topt = jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)
    cfg = _at(f32.cfg, ODD)
    jparams, jstate, jmet = jax.jit(jsteps.make_train_step(cfg, jopt))(
        f32.jp, jadamw.init_opt_state(f32.jp, jopt),
        {"image": jnp.asarray(x), "labels": jnp.asarray(y)})
    tparams = f32.tparams()
    out, tstate, tmet = tsteps.make_train_step(_at(f32.tcfg, ODD), topt)(
        tparams, tadamw.init_opt_state(tparams, topt),
        {"image": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    assert out is tparams
    assert set(tmet) == set(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   atol=1e-6, rtol=1e-5, err_msg=key)
    for tree, jtree in ((tstate["m"], jstate["m"]), (tstate["v"], jstate["v"])):
        jnamed = _named(_np_tree(jtree))
        for path, t in _named(tree).items():
            scale = np.abs(jnamed[path]).max()
            np.testing.assert_allclose(t.numpy(), jnamed[path],
                                       atol=GRAD_REL * scale, rtol=0,
                                       err_msg=path)
    # JAX's AdamW on the port's (clipped) gradient, from the same params
    grads = tadamw.tree_like(tstate["m"], {
        path: (m / (1 - topt.b1)).numpy()
        for path, m in tadamw.named_leaves(tstate["m"])})
    want, _, _ = jax.jit(lambda p, g, st: jadamw.adamw_update(
        p, g, st, jopt))(f32.jp, grads, jadamw.init_opt_state(f32.jp, jopt))
    wnamed, jnamed = _named(_np_tree(want)), _named(_np_tree(jparams))
    for path, t in _named(tparams).items():
        np.testing.assert_allclose(t.numpy(), wnamed[path], atol=1e-6,
                                   rtol=0, err_msg=path)
        np.testing.assert_allclose(t.numpy(), jnamed[path], atol=2e-3,
                                   rtol=2e-3, err_msg=path)


# ---------------------------------------------------------------------------
# input_specs and model_flops
# ---------------------------------------------------------------------------


def _spec_tree(tree):
    return {path: (tuple(s.shape), str(s.dtype).split(".")[-1])
            for path, s in _named(tree).items()}


def test_shape_configs_are_copies():
    assert {k: dataclasses.asdict(v) for k, v in tconfig.LM_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfig.LM_SHAPES.items()}


@pytest.mark.parametrize("arch", [ARCH, "qwen1.5-0.5b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_input_specs_and_model_flops_match_jax(arch, shape):
    jc, tc = jax_get_arch(arch).model, tconfig.get_arch(arch).model
    jshape, tshape = jconfig.LM_SHAPES[shape], tconfig.LM_SHAPES[shape]
    jspecs = japi.input_specs(jc, jshape)
    tspecs = tapi.input_specs(tc, tshape)
    jtree = jax.tree.map(lambda s: s, jspecs,
                         is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    assert _spec_tree(tspecs) == _spec_tree(jtree)
    jflops, tflops = japi.model_flops(jc, jshape), tapi.model_flops(tc, tshape)
    if arch == ARCH:
        assert set(tspecs) == {"image", "labels"}
        assert tspecs["image"] == ((tshape.global_batch, 1024, 2048, 3),
                                   torch.bfloat16)
        assert np.isnan(jflops) and np.isnan(tflops)
    else:
        assert tflops == jflops > 0


def test_token_trainer_refuses_the_convnet():
    with pytest.raises(ValueError, match="make_train_step"):
        ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_input_specs_refuse_what_the_port_does_not_run():
    """A family neither package knows (ValueError, as the reference's
    dispatch raises); the enc-dec and a decoder with a modality prefix get
    their specs now (the frames, the prefix's ``prefix_embeds``)."""
    cfg = tconfig.get_arch("qwen1.5-0.5b").smoke
    cell = tconfig.LM_SHAPES["train_4k"]
    with pytest.raises(ValueError, match="speech"):
        tapi.input_specs(dataclasses.replace(cfg, family="speech"), cell)
    vlm = dataclasses.replace(cfg, frontend=types.SimpleNamespace(
        kind="patch", num_prefix=4))
    assert sorted(tapi.input_specs(vlm, cell)) == ["prefix_embeds", "tokens"]
    assert sorted(tapi.input_specs(dataclasses.replace(cfg, family="encdec"),
                                   cell)) == ["frames", "tokens"]
