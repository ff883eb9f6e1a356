"""The port's server on the jamba hybrid (Mamba state beside an attention KV
cache) against the reference's model functions.

The port's ``BatchedServer`` admits a request into a hybrid through
``prefill`` of its prompt alone: the Mamba conv window and state replace the
slot's rows, and the attention cache of the prompt's L positions fills the
slot's first L positions of max_len.  Each request then gets, at every
step, the logits of its JAX *solo stream*: JAX ``prefill`` of the prompt
(its attention cache padded to max_len), then ``decode_step`` fed the last
prompt token (the server's first step feeds it again), then greedy tokens.
A slot's positions past L keep whatever they held: a row attends only up to
its own position, so they never leak into the stream.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.models import api as japi
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.launch import serve as tserve

ARCH = "jamba-1.5-large-398b"
PROMPT_LENS = (5, 9, 3, 7)
MAX_NEW, SLOTS, MAX_LEN = 6, 2, 32
N_SSM, N_ATTN = 7, 1                    # the smoke period's mixers

# jitted: eager JAX init of the smoke stack takes several times as long
_init = jax.jit(japi.init_params, static_argnums=1)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _pad_attention(cache):
    """A prefill cache's attention leaves, (periods, 1, Hkv, L, hd), padded
    with zeros to MAX_LEN positions."""
    def pad(path, leaf):
        if "attn" not in jax.tree_util.keystr(path):
            return leaf
        return jnp.pad(leaf, ((0, 0),) * 3 + ((0, MAX_LEN - leaf.shape[3]),
                                             (0, 0)))
    return jax.tree_util.tree_map_with_path(pad, cache)


class World:
    """Converted weights, the requests' prompts and each one's JAX solo
    stream of logits."""

    def __init__(self):
        self.jcfg = _f32(jax_get_arch(ARCH).smoke)
        self.tcfg = _f32(tconfig.get_arch(ARCH).smoke)
        self.jp = _init(jax.random.key(0), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp), "cpu")
        rng = np.random.default_rng(5)
        self.prompts = [rng.integers(0, self.jcfg.vocab_size, size=n)
                        .astype(np.int32) for n in PROMPT_LENS]
        cfg = self.jcfg
        prefill = jax.jit(lambda p, t: japi.prefill(p, cfg, {"tokens": t}))
        decode = jax.jit(lambda p, s, t, pos: japi.decode_step(
            p, cfg, s, t, pos))
        self.solo = []
        for prompt in self.prompts:
            _, state = prefill(self.jp, jnp.asarray(prompt[None]))
            state = _pad_attention(state)
            tok, out = prompt[-1], []
            for i in range(MAX_NEW):
                lg, state = decode(self.jp, state, jnp.asarray([tok], jnp.int32),
                                   jnp.asarray([len(prompt) + i], jnp.int32))
                out.append(np.asarray(lg[0]))
                tok = int(np.argmax(out[-1]))
            self.solo.append(out)


@pytest.fixture(scope="module")
def world():
    return World()


def _server(world):
    server = tserve.BatchedServer(world.tcfg, SLOTS, MAX_LEN,
                                  record_events=True, device="cpu")
    server.load(world.tp)
    return server


def _record(server):
    """Wrap ``server.step``: the logits each request gets at each step."""
    seen = {}
    decode, step = server.decode, server.step
    stepping = False

    def recording_decode(*args):
        logits, state = decode(*args)
        if stepping:
            for slot, req in enumerate(server.slot_req):
                if req is not None:
                    seen.setdefault(req.rid, []).append(
                        np.asarray(logits[slot], np.float32))
        return logits, state

    def recording_step():
        nonlocal stepping
        stepping = True
        try:
            return step()
        finally:
            stepping = False

    server.decode, server.step = recording_decode, recording_step
    return seen


def _assert_solo(world, seen, rid, req):
    want = world.solo[rid]
    assert len(seen[rid]) == MAX_NEW
    for w, h in zip(want, seen[rid]):
        np.testing.assert_allclose(h, w, atol=1e-4, rtol=0)
    assert req.out == [int(np.argmax(w)) for w in want]


def test_port_server_gives_every_request_its_solo_stream(world):
    """Two slots, four requests of different lengths: requests are admitted
    while another decodes and into slots that finished requests freed (the
    third request's 3-token prompt goes into a slot whose positions 3-10
    still hold the first request's keys and values)."""
    server = _server(world)
    seen = _record(server)
    reqs = [tserve.Request(i, p, max_new=MAX_NEW)
            for i, p in enumerate(world.prompts)]
    pending = list(reqs)
    while not all(r.done for r in reqs):
        while pending and server.admit(pending[0]):
            pending.pop(0)
        server.step()
    assert server.events.index(("admit", 2)) > server.events.index(("finish", 0))
    for rid, req in enumerate(reqs):
        _assert_solo(world, seen, rid, req)


def test_stale_attention_rows_past_the_prompt_do_not_leak(world):
    """Fill the whole cache with noise, then serve one request: admission
    writes the slot's recurrent state and its first L attention positions
    and nothing else (the slot's later positions and the other slot keep the
    noise), and the stream is still the solo one."""
    server = _server(world)
    seen = _record(server)
    for leaf in jax.tree_util.tree_leaves(server.state):
        leaf.normal_(0.0, 10.0)
    noise = jax.tree.map(torch.clone, server.state)
    req = tserve.Request(1, world.prompts[1], max_new=MAX_NEW)
    L = len(req.prompt)
    assert server.admit(req)
    for got, kept in zip(jax.tree_util.tree_leaves(server.state),
                         jax.tree_util.tree_leaves(noise)):
        torch.testing.assert_close(got[:, 1], kept[:, 1], rtol=0, atol=0)
    for kv in ("k", "v"):
        got = server.state["periods"]["sub4"]["attn"][kv][:, 0]
        kept = noise["periods"]["sub4"]["attn"][kv][:, 0]
        torch.testing.assert_close(got[:, :, L:], kept[:, :, L:], rtol=0, atol=0)
        assert not torch.equal(got[:, :, :L], kept[:, :, :L])
    while not req.done:
        server.step()
    _assert_solo(world, seen, 1, req)


def test_admission_and_steps_run_the_kernels_ops(world):
    """An admission runs the scan op once per Mamba layer and flash
    attention once per attention layer; a decode step runs the scan op once
    per Mamba layer and flash-decode once per attention layer."""
    server = _server(world)
    calls = lambda: (sops.ref.calls, fops.ref.calls, dops.ref.calls)  # noqa: E731
    before = calls()
    for rid in range(2):
        assert server.admit(tserve.Request(rid, world.prompts[rid], MAX_NEW))
    assert np.subtract(calls(), before).tolist() == [2 * N_SSM, 2 * N_ATTN, 0]
    before = calls()
    server.step()
    assert np.subtract(calls(), before).tolist() == [N_SSM, 0, N_ATTN]
    assert server.slot_pos.tolist() == [PROMPT_LENS[0] + 1, PROMPT_LENS[1] + 1]


def test_main_serves_jamba_smoke_on_cpu(capsys):
    queue = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--requests", "3", "--slots", "2", "--max-new", "4",
                         "--prompt-len", "5"])
    assert all(r.done and len(r.out) == 4 for r in queue)
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
