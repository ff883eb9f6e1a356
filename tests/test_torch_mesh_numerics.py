"""The port on a mesh computes what the JAX package computes: CPU
processes on ``gloo`` (``tests/_torch_mesh_worker.py``, a ``FileStore``
under the test's temporary directory) run the dense and MoE smokes in f32
on the ("data", "model") meshes (1, 2) and (2, 1) (two processes), and
granite-moe's also on (2, 2) and (1, 4) (four processes: on (2, 2) its
experts lie on "model" and their FSDP shard on "data", both over 1; on
(1, 4) its 2 KV heads do not divide the ranks and, with ``seq_parallel``,
its cache lies on its keys).  Forward, prefill, 4 decode steps (the cache
on heads or replicated, and with ``seq_parallel`` on its keys), the loss
and its MoE aux term match the reference at 1e-4, the gradients at 2e-3
(as ``tests/test_models.py`` holds them), and one train step moves each
param as the reference's does, within a hundredth of the rate.  Beside
qwen1.5 (MHA) and minitron (GQA 4/2), qwen2.5's smoke with 9 query heads
on 3 KV heads: on 2 ranks its heads pad to 10, a rank's query heads
straddle two KV groups, and its cache (3 KV heads) lies on its keys.
granite-k1 puts a dense block in front of the MoE one (``first_k_dense``
1, as deepseek-v2's stack has); granite-dropless routes with no capacity
(``capacity_factor`` -1, C = S K).
granite-moe runs at its default capacity factor, 1.25: C = 5 slots an
expert for a row's 16 choices over 4 experts, and the draw drops choices
(its forward differs from the dropless one).
K1's plain version over key shards, merged by log-sum-exp, equals it over
the whole cache."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import OptimizerConfig as JOptimizerConfig
from repro.core.config import get_arch as jax_get_arch
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro_torch.convert import params_from_jax
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      merge_partials)
from repro_torch.optim.adamw import named_leaves

HERE = Path(__file__).resolve().parent
# case: (arch, its smoke's (heads, KV heads) if changed, changes to its
# MoE config)
CASES = {"qwen1.5": ("qwen1.5-0.5b", None, {}),
         "minitron": ("minitron-8b", None, {}),
         "gqa9-3": ("qwen2.5-14b", (9, 3), {}),
         "granite": ("granite-moe-1b-a400m", None, {}),
         "granite-k1": ("granite-moe-1b-a400m", None, {"first_k_dense": 1}),
         "granite-dropless": ("granite-moe-1b-a400m", None,
                              {"capacity_factor": -1.0})}
MESHES = ("1x2", "2x1")
# the four-process meshes, and the cases run on them
MESHES4, CASES4 = ("2x2", "1x4"), ("granite",)
CELLS = [(c, m) for c in CASES for m in MESHES] \
    + [(c, m) for c in CASES4 for m in MESHES4]
CELL_IDS = [f"{c}-{m}" for c, m in CELLS]
B, S, MAX_LEN, STEPS = 2, 8, 8, 4
ATOL, GRAD = 1e-4, dict(atol=2e-3, rtol=2e-3)
LR = JOptimizerConfig().lr


def jax_smoke(arch, heads, moe=None):
    cfg = jax_get_arch(arch).smoke
    if heads:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, num_heads=heads[0], num_kv_heads=heads[1]))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def reference(cfg, params, tokens):
    """The JAX package's outputs of every step the worker runs."""
    batch = {"tokens": jnp.asarray(tokens)}
    out = {"forward": jax.jit(lambda p: japi.forward(
        p, cfg, batch, mode="train", remat="none")[0])(params)}
    out["prefill"], out["prefill_cache"] = jax.jit(
        lambda p: japi.prefill(p, cfg, batch))(params)
    loss_of = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, cfg, batch, remat="none")[0]))
    out["loss"], out["grads"] = loss_of(params)
    out["aux"] = jax.jit(lambda p: japi.loss_fn(
        p, cfg, batch, remat="none")[1]["aux"])(params)
    # the worker's optimizer: no warmup, so that step 1 runs at the full
    # learning rate and moves each param by up to that much; eps 1e-3, so
    # that the move, lr g / (|g| + eps) in AdamW's first step, is a smooth
    # function of the gradient (at eps 1e-8 a gradient within rounding of
    # zero moves its param by anything in (-lr, lr))
    opt_cfg = JOptimizerConfig(warmup_steps=0, eps=1e-3)
    step = jsteps.make_train_step(cfg, opt_cfg, remat="none")
    out["trained"], _, metrics = jax.jit(step)(
        params, jadamw.init_opt_state(params, opt_cfg), batch)
    out["grad_norm"] = metrics["grad_norm"]
    out["params"] = params
    state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         japi.init_decode_state(cfg, B, MAX_LEN))
    dec = jax.jit(lambda p, s, t, i: japi.decode_step(p, cfg, s, t, i))
    logits = []
    for i in range(STEPS):
        lg, state = dec(params, state, batch["tokens"][:, i], jnp.int32(i))
        logits.append(lg)
    out["decode"] = jnp.stack(logits)
    return jax.tree.map(np.asarray, out)


def _start(path, world, env):
    return [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_mesh_worker.py"), str(path),
         str(rank), str(world)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]


def _finish(procs, timeout=300):
    """Each process's stderr, each waited for ``timeout`` seconds at most;
    all are killed if one runs over."""
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    assert all(p.returncode == 0 for p in procs), errs[0][-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs by case, and the port's by "case:mesh:sp",
    from two groups of processes run at once: two ranks for every case,
    four for ``CASES4``."""
    paths = {2: tmp_path_factory.mktemp("mesh2"),
             4: tmp_path_factory.mktemp("mesh4")}
    inputs, refs = {}, {}
    for case, (arch, heads, moe) in CASES.items():
        cfg = jax_smoke(arch, heads, moe)
        params = japi.init_params(jax.random.key(1), cfg)
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        refs[case] = reference(cfg, params, tokens)
        if case == "granite":   # the same, dropless
            dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=-1.0))
            refs[case]["forward_dropless"] = np.asarray(jax.jit(
                lambda p: japi.forward(p, dropless, {"tokens": jnp.asarray(
                    tokens)}, mode="train", remat="none")[0])(params))
        inputs[case] = {"arch": arch, "heads": heads, "moe": moe,
                        "params": params_from_jax(
                            jax.tree.map(np.asarray, params), "cpu"),
                        "tokens": torch.from_numpy(tokens)}
    torch.save(inputs, paths[2] / "inputs.pt")
    torch.save({c: inputs[c] for c in CASES4}, paths[4] / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = {world: _start(path, world, env) for world, path in paths.items()}
    for world in procs:
        _finish(procs[world])
    out = {}
    for path in paths.values():
        out.update(torch.load(path / "out.pt"))
    return refs, out


def _flat(tree):
    return dict(named_leaves(tree)) if isinstance(tree, dict) else {"": tree}


def _close(ref, got, **tol):
    tol = tol or dict(atol=ATOL, rtol=0)
    ref, got = _flat(ref), _flat(got)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("case,mesh", CELLS, ids=CELL_IDS)
def test_forward_and_prefill_match_the_reference(runs, case, mesh):
    refs, out = runs
    got = out[f"{case}:{mesh}:sp0"]
    _close(refs[case]["forward"], got["forward"])
    _close(refs[case]["prefill"], got["prefill"])
    _close(refs[case]["prefill_cache"], got["prefill_cache"])


@pytest.mark.parametrize("sp", [0, 1])
@pytest.mark.parametrize("case,mesh", CELLS, ids=CELL_IDS)
def test_decode_matches_the_reference(runs, case, mesh, sp):
    refs, out = runs
    got = out[f"{case}:{mesh}:sp{sp}"]
    _close(refs[case]["decode"], got["decode"])
    # where the cache lies: (periods, batch, KV heads, keys, hd): its KV
    # heads on "model" where they divide it, else (seq_parallel) its keys
    d, m = (int(n) for n in mesh.split("x"))
    kv = jax_smoke(*CASES[case]).attention.num_kv_heads
    on_heads = m > 1 and kv % m == 0
    want = (None, "data" if d > 1 else None, "model" if on_heads else None,
            "model" if m > 1 and not on_heads and sp else None, None)
    assert got["state_spec"] == want


@pytest.mark.parametrize("case,mesh", CELLS, ids=CELL_IDS)
def test_loss_gradient_and_train_step_match_the_reference(runs, case, mesh):
    refs, out = runs
    got = out[f"{case}:{mesh}:sp0"]
    _close(refs[case]["loss"], got["loss"])
    _close(refs[case]["aux"], got["aux"])
    _close(refs[case]["grads"], got["grads"], **GRAD)
    _close(refs[case]["grad_norm"], got["grad_norm"], **GRAD)
    # the step's move of each param (up to the learning rate) is the
    # reference's within a hundredth of the rate
    params = _flat(refs[case]["params"])
    want = {k: np.asarray(v) - params[k]
            for k, v in _flat(refs[case]["trained"]).items()}
    moved = {k: v.numpy() - params[k]
             for k, v in _flat(got["trained"]).items()}
    assert set(moved) == set(want)
    assert max(np.abs(v).max() for v in want.values()) > LR / 2
    for k in want:
        np.testing.assert_allclose(moved[k], want[k], atol=LR / 100, rtol=0,
                                   err_msg=k)


def test_granite_draw_drops_choices_at_capacity(runs):
    """The MoE case holds the drop path: at capacity factor 1.25 the
    reference's forward differs from its dropless one, so at least one
    choice found its expert's 5 slots taken.  Its aux term is far from
    zero and the router and expert leaves have gradients, so the mesh's
    are held."""
    refs, _ = runs
    ref = refs["granite"]
    assert np.abs(ref["forward"] - ref["forward_dropless"]).max() > 1e-3
    assert float(ref["aux"]) > 0.5
    flat = _flat(ref["grads"])
    assert {"/stack/periods/sub0/ffn_moe/router/w",
            "/stack/periods/sub0/ffn_moe/w_up"} <= set(flat)


@pytest.mark.parametrize("shards", [2, 3, 16])
def test_k1_merged_over_key_shards_equals_the_whole_cache(shards):
    """K1's plain version over each shard of the keys (its own kv_len,
    clamped: some shards hold no valid key, lse -inf, output 0) and the
    results merged equal it over the whole cache, with no NaN."""
    g = torch.Generator().manual_seed(0)
    Bq, Hq, Hkv, Sk, hd = 3, 8, 2, 64, 16
    q = torch.randn(Bq, Hq, hd, generator=g)
    k = torch.randn(Bq, Hkv, Sk, hd, generator=g)
    v = torch.randn(Bq, Hkv, Sk, hd, generator=g)
    kv_len = torch.tensor([64, 17, 1], dtype=torch.int32)
    whole, lse = decode_attention_ref(q, k, v, kv_len, return_lse=True)
    chunk = -(-Sk // shards)
    outs, lses = [], []
    for s in range(shards):
        lo = s * chunk
        part = slice(lo, min(lo + chunk, Sk))
        n = (kv_len - lo).clamp(0, chunk).to(torch.int32)
        o, l = decode_attention_ref(q, k[:, :, part].contiguous(),
                                    v[:, :, part].contiguous(), n,
                                    return_lse=True)
        outs.append(o)
        lses.append(l)
    assert torch.isinf(lses[-1][2]).all()          # row 2 has one key
    merged = merge_partials(torch.stack(outs), torch.stack(lses))
    assert torch.isfinite(merged).all()
    torch.testing.assert_close(merged, whole, atol=3e-5, rtol=0)
    # the merged log-sum-exp is the whole one's
    torch.testing.assert_close(torch.logsumexp(torch.stack(lses), 0), lse,
                               atol=3e-5, rtol=0)


def test_k1_merge_of_no_keys_is_zero():
    outs = torch.zeros(2, 1, 2, 4)
    lses = torch.full((2, 1, 2), -float("inf"))
    merged = merge_partials(outs, lses)
    assert torch.equal(merged, torch.zeros(1, 2, 4))
