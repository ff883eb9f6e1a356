"""The port's own self-consistency checks on the model path, the twins of
``tests/test_models.py``'s: token-by-token decode and prefill reproduce the
full forward, for the qwen1.5 and minitron smoke configs with the port's own
random params.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core import config as tconfig
from repro_torch.models import api as tapi

ATOL = 1e-4          # the reference's own bound is 2e-3 (test_models.py)
B, T = 2, 12


class Model:
    def __init__(self, arch):
        self.cfg = dataclasses.replace(tconfig.get_arch(arch).smoke,
                                       param_dtype="float32",
                                       compute_dtype="float32")
        self.params = tapi.init_params(torch.Generator().manual_seed(1),
                                       self.cfg)
        self.tokens = np.random.default_rng(0).integers(
            0, self.cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.fixture(scope="module", params=["qwen1.5-0.5b", "minitron-8b"])
def model(request):
    return Model(request.param)


def test_decode_matches_forward(model):
    """The port's own self-consistency: token-by-token decode reproduces the
    full forward (test_models.py's check, on the port)."""
    full, _ = tapi.forward(model.params, model.cfg,
                           {"tokens": torch.from_numpy(model.tokens)})
    state = tapi.allocate_decode_state(model.cfg, B, T, "cpu")
    for t in range(T):
        logits, state = tapi.decode_step(
            model.params, model.cfg, state, torch.from_numpy(model.tokens[:, t]),
            torch.tensor(t, dtype=torch.int32))
        torch.testing.assert_close(logits, full[:, t], atol=ATOL, rtol=0)


def test_prefill_matches_forward(model):
    full, _ = tapi.forward(model.params, model.cfg,
                           {"tokens": torch.from_numpy(model.tokens)})
    last, cache = tapi.prefill(model.params, model.cfg,
                               {"tokens": torch.from_numpy(model.tokens)})
    torch.testing.assert_close(last[:, 0], full[:, -1], atol=ATOL, rtol=0)
    a = model.cfg.attention
    assert cache["periods"]["sub0"]["attn"]["k"].shape == \
        (model.cfg.num_layers, B, a.num_kv_heads, T, a.head_dim)


def test_unported_families_raise():
    """Every family of the reference runs in the port now (the VLM prefix:
    test_torch_vlm.py; the enc-dec: test_torch_encdec.py); a family it does
    not know raises ValueError, as the reference's dispatch does.  A
    modality frontend on a decoder takes a batch without a prefix as a
    text-only batch."""
    cfg = Model("qwen1.5-0.5b").cfg
    with pytest.raises(ValueError, match="speech"):
        tapi.init_params(torch.Generator(),
                         dataclasses.replace(cfg, family="speech"))
    params = tapi.init_params(torch.Generator().manual_seed(0), cfg)
    vlm = dataclasses.replace(cfg, frontend=types.SimpleNamespace(
        kind="patch", num_prefix=4))
    tokens = {"tokens": torch.zeros(1, 3, dtype=torch.long)}
    torch.testing.assert_close(tapi.forward(params, vlm, tokens)[0],
                               tapi.forward(params, cfg, tokens)[0])
