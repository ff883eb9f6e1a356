"""The hybrid family on a mesh computes what the JAX package computes:
jamba's smoke (a period of 8 layers: Mamba mixers with dense and MoE FFNs,
GQA attention at layer 4) in f32 on the ("data", "model") meshes (1, 2)
and (2, 1) (two ``gloo`` processes) and (2, 2) and (1, 4) (four), through
``tests/_torch_mesh_worker.py``, run beside the two groups of
``test_torch_mesh_numerics.py`` as a file of its own.  Forward, prefill
(its cache too), 4 decode steps with ``seq_parallel`` off and on, the
loss and its MoE aux term match the reference at 1e-4, the gradients at
2e-3, and one train step moves each param as the reference's does within
a hundredth of the rate, the tolerances of the dense and MoE cases.

The Mamba mixer lays its d_inner channels on "model" (the reference's
"mlp"): the u/z split's all-to-all gives each rank its own channels of u
and of z; K3 runs on each rank's rows and channels, its dB and dC the sum
of the ranks' shares; a decode step writes the state into the cache's own
local shard."""
import dataclasses
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro_torch.convert import params_from_jax
from test_torch_mesh_numerics import (ATOL, GRAD, LR, B, S, _close, _finish,
                                      _flat, _start, jax_smoke, reference)

HERE = Path(__file__).resolve().parent
ARCH = "jamba-1.5-large-398b"
MESHES = {2: ("1x2", "2x1"), 4: ("2x2", "1x4")}
ALL = MESHES[2] + MESHES[4]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and the port's by "jamba:mesh:sp" (and
    "jamba:mesh:units"), from a group of two processes and one of four,
    run at once."""
    cfg = jax_smoke(ARCH, None)
    params = japi.init_params(jax.random.key(1), cfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref = reference(cfg, params, tokens)
    inputs = {"jamba": {"arch": ARCH, "heads": None, "moe": {},
                        "params": params_from_jax(
                            jax.tree.map(np.asarray, params), "cpu"),
                        "tokens": torch.from_numpy(tokens), "units": True}}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    paths, procs = {}, {}
    for world in MESHES:
        paths[world] = tmp_path_factory.mktemp(f"hybrid{world}")
        torch.save(inputs, paths[world] / "inputs.pt")
        procs[world] = _start(paths[world], world, env)
    for world in procs:
        _finish(procs[world])
    out = {}
    for path in paths.values():
        out.update(torch.load(path / "out.pt", weights_only=False))
    return ref, out


def _dims(mesh):
    return tuple(int(n) for n in mesh.split("x"))


@pytest.mark.parametrize("mesh", ALL)
def test_forward_and_prefill_match_the_reference(runs, mesh):
    ref, out = runs
    got = out[f"jamba:{mesh}:sp0"]
    _close(ref["forward"], got["forward"])
    _close(ref["prefill"], got["prefill"])
    _close(ref["prefill_cache"], got["prefill_cache"])


@pytest.mark.parametrize("sp", [0, 1])
@pytest.mark.parametrize("mesh", ALL)
def test_decode_matches_the_reference(runs, mesh, sp):
    """4 decode steps; the Mamba cache on ("batch", None, "mlp") and
    ("batch", "mlp", None) (d_inner 128 on "model"), the attention cache's
    2 KV heads on "model" where they divide it, else with ``seq_parallel``
    on its keys."""
    ref, out = runs
    got = out[f"jamba:{mesh}:sp{sp}"]
    _close(ref["decode"], got["decode"])
    d, m = _dims(mesh)
    data, model = ("data" if d > 1 else None), ("model" if m > 1 else None)
    on_heads = m > 1 and 2 % m == 0
    assert got["state_spec"] == (None, data, model if on_heads else None,
                                 "model" if m > 1 and not on_heads and sp
                                 else None, None)
    assert got["ssm_spec"] == ((None, data, None, model),
                               (None, data, model, None))


@pytest.mark.parametrize("mesh", ALL)
def test_loss_gradient_and_train_step_match_the_reference(runs, mesh):
    ref, out = runs
    got = out[f"jamba:{mesh}:sp0"]
    _close(ref["loss"], got["loss"])
    _close(ref["aux"], got["aux"])
    _close(ref["grads"], got["grads"], **GRAD)
    _close(ref["grad_norm"], got["grad_norm"], **GRAD)
    params = _flat(ref["params"])
    want = {k: np.asarray(v) - params[k]
            for k, v in _flat(ref["trained"]).items()}
    moved = {k: v.numpy() - params[k]
             for k, v in _flat(got["trained"]).items()}
    assert set(moved) == set(want)
    assert max(np.abs(v).max() for v in want.values()) > LR / 2
    # each of the first mixer's 9 leaves moves by ten times the tolerance
    # (the conv taps, A_log and D, read in slices on "model", among them)
    mixer = [k for k in want if "/sub0/ssm/" in k]
    assert len(mixer) == 9 and all(np.abs(want[k]).max() > LR / 10
                                   for k in mixer)
    for k in want:
        np.testing.assert_allclose(moved[k], want[k], atol=LR / 100, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", ALL)
def test_uz_split_gives_each_rank_its_channels(runs, mesh):
    """in_proj's (B, S, 2 di) output with its columns on "model": after the
    split each rank holds its batch rows and its di/m channels of u and of
    z, the reference's slices ``xz[..., :di]`` and ``xz[..., di:]``."""
    _, out = runs
    got = out[f"jamba:{mesh}:units"]
    g = torch.Generator().manual_seed(3)
    di = 2 * jax_smoke(ARCH, None).d_model
    xz = torch.randn(2, 8, 2 * di, generator=g)
    assert torch.equal(got["split"][0], xz[..., :di])
    assert torch.equal(got["split"][1], xz[..., di:])
    assert got["split_local_err"] == 0.0
    m = _dims(mesh)[1]
    assert got["split_placements"][0] == got["split_placements"][1]
    assert ("Shard(dim=2)" in got["split_placements"][0]) == (m > 1)


@pytest.mark.parametrize("mesh", ALL)
def test_k3_on_each_ranks_channels_equals_the_whole_scan(runs, mesh):
    """K3's plain version on each rank's rows and channels (``local_map``,
    its slice of A_log and D) equals the scan over every channel, and so
    do its gradients: dB and dC summed over the ranks' channels, dA_log
    and dD over their rows and channels."""
    _, out = runs
    got = out[f"jamba:{mesh}:units"]
    for k, want in got["scan_want"].items():
        torch.testing.assert_close(got["scan_got"][k], want, atol=1e-5,
                                   rtol=1e-5, msg=k)


@pytest.mark.parametrize("mesh", ALL)
def test_decode_writes_the_state_into_the_cache_in_place(runs, mesh):
    """A decode step (S = 1) with ``in_place``: on every rank the returned
    state's local tensor is the cache's own (one data_ptr), and the cache
    holds the whole scan's final state."""
    _, out = runs
    got = out[f"jamba:{mesh}:units"]
    assert got["in_place_all_ranks"]
    want_y, want_h = got["decode_want"]
    torch.testing.assert_close(got["decode_y"], want_y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got["decode_state"], want_h, atol=1e-5,
                               rtol=1e-5)
