"""The two dense GQA configs served on one card, qwen2.5-14b (whole) and
mistral-large-123b (``CARD``, its first 16 layers): the port's parameter
counts equal the reference's, from the configs alone (``param_shapes``
traces the init with fake tensors and allocates nothing), and equal the
numbers each config's docstring states.
"""
import dataclasses

import pytest

from repro.core.config import get_arch as jax_get_arch
from repro.models import api as japi
from repro_torch.configs import mistral_large_123b, qwen2_5_14b
from repro_torch.core import config as tconfig
from repro_torch.models import api as tapi

# (arch, layers, the whole model's count, one layer's, the rest's: the
# embedding, the untied head and the final norm)
COUNTS = {
    "qwen2.5-14b": (48, 14_770_033_664, 275_268_608, 1_557_140_480),
    "mistral-large-123b": (88, 122_610_069_504, 1_384_144_896, 805_318_656),
}
MODULE = {"qwen2.5-14b": qwen2_5_14b,
          "mistral-large-123b": mistral_large_123b}


@pytest.mark.parametrize("arch", sorted(COUNTS))
def test_full_param_count_matches_jax(arch):
    layers, total, layer, rest = COUNTS[arch]
    cfg = tconfig.get_arch(arch).model
    assert cfg is MODULE[arch].FULL and cfg.num_layers == layers
    assert tapi.param_count(cfg) == japi.param_count(
        jax_get_arch(arch).model) == total == layers * layer + rest
    # dense: every parameter is active
    assert tapi.param_count(cfg, active_only=True) == total


@pytest.mark.parametrize("arch", sorted(COUNTS))
def test_one_layer_and_the_rest(arch):
    """A layer's count and the rest's, each as the docstring states."""
    _, _, layer, rest = COUNTS[arch]
    one = dataclasses.replace(tconfig.get_arch(arch).model, num_layers=1)
    assert tapi.param_count(one) == japi.param_count(dataclasses.replace(
        jax_get_arch(arch).model, num_layers=1)) == layer + rest


@pytest.mark.parametrize("arch", sorted(COUNTS))
def test_docstring_states_the_counts(arch):
    _, total, layer, rest = COUNTS[arch]
    doc = " ".join(MODULE[arch].__doc__.split())
    for n in (total, layer, rest):
        assert f"{n:,}" in doc


def test_mistral_card_is_full_cut_to_16_layers():
    card = mistral_large_123b.CARD
    full = mistral_large_123b.FULL
    assert dataclasses.replace(card, num_layers=full.num_layers) == full
    assert card.num_layers == 16
    assert card.param_dtype == card.compute_dtype == "bfloat16"
    # not registered: the registry serves the published model
    assert tconfig.get_arch("mistral-large-123b").model is full
    _, _, layer, rest = COUNTS["mistral-large-123b"]
    jcard = dataclasses.replace(jax_get_arch("mistral-large-123b").model,
                                num_layers=16)
    n = tapi.param_count(card)
    assert n == japi.param_count(jcard) == 16 * layer + rest \
        == 22_951_636_992
    doc = " ".join(mistral_large_123b.__doc__.split())
    assert f"{n:,}" in doc
    # its bf16 weights, as the docstring states them
    assert f"{2 * n / 1e9:.1f} GB" in doc


def test_qwen_full_fits_the_card_in_bf16():
    cfg = qwen2_5_14b.FULL
    assert cfg.param_dtype == "bfloat16"
    n = tapi.param_count(cfg)
    doc = " ".join(qwen2_5_14b.__doc__.split())
    assert f"{2 * n / 1e9:.1f} GB" in doc
    assert 2 * n < 80e9
