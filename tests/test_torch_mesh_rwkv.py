"""The RWKV-6 family on a mesh computes what the JAX package computes:
rwkv6-1.6b's smoke (2 layers, d_model 64, 4 heads of 16) in f32 on the
("data", "model") meshes (1, 2) and (2, 1) (two ``gloo`` processes) and
(2, 2) and (1, 4) (four), through ``tests/_torch_mesh_worker.py``, run
beside the other mesh files' groups as a file of its own.  Forward,
prefill (its ``wkv``, ``shift_t`` and ``shift_c`` too), 4 decode steps
with ``seq_parallel`` off and on, and the loss match the reference at
1e-4, the gradients at 2e-3, and one train step moves each param as the
reference's does within a hundredth of the rate, the tolerances of the
dense, MoE and hybrid cases.

The time mix's heads lie on "model" (1 a rank on (1, 4), 2 on (1, 2)):
K4 runs on each rank's rows and heads (``rwkv6_scan_by_heads``), its du
the sum of the ranks' shares; a decode step's closed form writes the WKV
state into the cache's own local shard.  The lerps and the decay stay on
each rank's d_model channels, the replicated lora weights read in slices,
so their gradients are the slices' (the train step holds every leaf's
move)."""
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro_torch.convert import params_from_jax
from test_torch_mesh_numerics import (GRAD, LR, B, S, _close, _finish, _flat,
                                      _start, jax_smoke, reference)

HERE = Path(__file__).resolve().parent
ARCH = "rwkv6-1.6b"
MESHES = {2: ("1x2", "2x1"), 4: ("2x2", "1x4")}
ALL = MESHES[2] + MESHES[4]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and the port's by "rwkv:mesh:sp" (and
    "rwkv:mesh:units"), from a group of two processes and one of four,
    run at once."""
    cfg = jax_smoke(ARCH, None)
    params = japi.init_params(jax.random.key(1), cfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref = reference(cfg, params, tokens)
    inputs = {"rwkv": {"arch": ARCH, "heads": None, "moe": {},
                       "params": params_from_jax(
                           jax.tree.map(np.asarray, params), "cpu"),
                       "tokens": torch.from_numpy(tokens), "units": True}}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    paths, procs = {}, {}
    for world in MESHES:
        paths[world] = tmp_path_factory.mktemp(f"rwkv{world}")
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
    """The forward's logits, prefill's last logits and its cache: each
    layer's WKV state and both token-shift rows."""
    ref, out = runs
    got = out[f"rwkv:{mesh}:sp0"]
    _close(ref["forward"], got["forward"])
    _close(ref["prefill"], got["prefill"])
    _close(ref["prefill_cache"], got["prefill_cache"])


@pytest.mark.parametrize("sp", [0, 1])
@pytest.mark.parametrize("mesh", ALL)
def test_decode_matches_the_reference(runs, mesh, sp):
    """4 decode steps; the cache's ``wkv`` on ("batch", "heads", None,
    None), its 4 heads on "model", and ``shift_t`` / ``shift_c`` on
    ("batch", "embed"), d_model 64 on "model", with ``seq_parallel`` off
    and on alike (the state has no sequence dim)."""
    ref, out = runs
    got = out[f"rwkv:{mesh}:sp{sp}"]
    _close(ref["decode"], got["decode"])
    d, m = _dims(mesh)
    data, model = ("data" if d > 1 else None), ("model" if m > 1 else None)
    assert got["rwkv_spec"] == ((None, data, model, None, None),
                                (None, data, model), (None, data, model))


@pytest.mark.parametrize("mesh", ALL)
def test_loss_gradient_and_train_step_match_the_reference(runs, mesh):
    ref, out = runs
    got = out[f"rwkv:{mesh}:sp0"]
    _close(ref["loss"], got["loss"])
    _close(ref["grads"], got["grads"], **GRAD)
    _close(ref["grad_norm"], got["grad_norm"], **GRAD)
    params = _flat(ref["params"])
    want = {k: np.asarray(v) - params[k]
            for k, v in _flat(ref["trained"]).items()}
    moved = {k: v.numpy() - params[k]
             for k, v in _flat(got["trained"]).items()}
    assert set(moved) == set(want)
    assert max(np.abs(v).max() for v in want.values()) > LR / 2
    # u and the lerps' lora, which a rank reads in its heads' or channels'
    # slice, each move by ten times the tolerance
    sliced = [k for k in want if k.rsplit("/", 1)[-1]
              in ("u", "lora_base_a", "lora_base_b")]
    assert len(sliced) == 3 and all(np.abs(want[k]).max() > LR / 10
                                    for k in sliced)
    for k in want:
        np.testing.assert_allclose(moved[k], want[k], atol=LR / 100, rtol=0,
                                   err_msg=k)
    # the decay's leaves, also read in slices, take gradients too small
    # for their moves to show (w0 near -5: logw ~ -7e-3; they move by
    # 5e-5 to 0.03 of the rate): held to the reference's gradient within
    # 1e-4 of its own largest element
    grads, ref_grads = _flat(got["grads"]), _flat(ref["grads"])
    decay = [k for k in ref_grads if k.rsplit("/", 1)[-1]
             in ("w0", "w_lora_a", "w_lora_b", "mu_w")]
    assert len(decay) == 4
    for k in decay:
        g = np.asarray(ref_grads[k])
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("mesh", ALL)
def test_k4_on_each_ranks_heads_equals_the_whole_scan(runs, mesh):
    """K4's plain version on each rank's rows and heads (``local_map``, its
    rows of u) equals the op over every head, and so do its gradients: du
    summed over the ranks' rows and heads; the output lies on the heads'
    "model" shard where there is one."""
    _, out = runs
    got = out[f"rwkv:{mesh}:units"]
    for k, want in got["scan_want"].items():
        torch.testing.assert_close(got["scan_got"][k], want, atol=1e-5,
                                   rtol=1e-5, msg=k)
    assert ("Shard(dim=1)" in got["placements"]) == (_dims(mesh)[1] > 1)


@pytest.mark.parametrize("mesh", ALL)
def test_decode_writes_the_state_into_the_cache_in_place(runs, mesh):
    """A decode step of ``apply_time_mix`` on the mesh: on every rank the
    returned ``wkv`` and ``shift_t`` are the cache's own local tensors (one
    data_ptr each), and the output and the cache equal the step on the
    whole tensors."""
    _, out = runs
    got = out[f"rwkv:{mesh}:units"]
    assert got["in_place_all_ranks"]
    want_y, want_state = got["decode_want"]
    torch.testing.assert_close(got["decode_y"], want_y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got["decode_state"], want_state, atol=1e-5,
                               rtol=1e-5)
