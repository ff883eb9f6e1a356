"""The port's server on a recurrent model (RWKV-6) against the reference's
model functions.

The port's ``BatchedServer`` admits a request into an RWKV model through
``prefill`` of its prompt alone and writes the returned state into the
slot's rows.  Each request then gets, at every step, the logits of its JAX
*solo stream*: JAX ``prefill`` of the prompt, then ``decode_step`` fed the
last prompt token (the server's first step feeds it again), then greedy
tokens.  The reference ``BatchedServer`` prefills token by token through the
batch's decode step, which advances every other active slot's recurrent
state and keeps a reused slot's old state; the last test shows that it
departs from the solo stream on the same requests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.launch import serve as jserve
from repro.models import api as japi
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.rwkv6_scan import ops as kops
from repro_torch.launch import serve as tserve

ARCH = "rwkv6-1.6b"
PROMPT_LENS = (5, 9, 3, 7)
MAX_NEW, SLOTS, MAX_LEN = 6, 2, 32

# jitted: eager JAX init of the smoke stack takes twice as long
_init = jax.jit(japi.init_params, static_argnums=1)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


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


def _serve(mod, cfg, params, prompts, **kw):
    """Serve ``prompts`` on SLOTS slots; returns (requests, server, the
    logits each request got at each of its decode steps)."""
    server = mod.BatchedServer(cfg, SLOTS, MAX_LEN, record_events=True, **kw)
    server.load(params)
    seen = {i: [] for i in range(len(prompts))}
    decode, step = server.decode, server.step
    stepping = False

    def recording_decode(*args):
        logits, state = decode(*args)
        if stepping:
            for slot, req in enumerate(server.slot_req):
                if req is not None:
                    seen[req.rid].append(np.asarray(logits[slot], np.float32))
        return logits, state

    def recording_step():
        nonlocal stepping
        stepping = True
        try:
            return step()
        finally:
            stepping = False

    server.decode, server.step = recording_decode, recording_step
    reqs = [mod.Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    pending = list(reqs)
    while not all(r.done for r in reqs):
        while pending and server.admit(pending[0]):
            pending.pop(0)
        server.step()
    return reqs, server, seen


def test_port_server_gives_every_request_its_solo_stream(world):
    """Two slots, four requests of different lengths: requests are admitted
    while another decodes and into slots that finished requests freed."""
    reqs, server, seen = _serve(tserve, world.tcfg, world.tp, world.prompts,
                                device="cpu")
    admits = [e for e in server.events if e[0] == "admit"]
    assert len(admits) == 4 and server.events.index(("admit", 2)) > \
        server.events.index(("finish", 0))        # a reused slot
    for rid, want in enumerate(world.solo):
        assert len(seen[rid]) == MAX_NEW
        for w, h in zip(want, seen[rid]):
            np.testing.assert_allclose(h, w, atol=1e-4, rtol=0)
        assert reqs[rid].out == [int(np.argmax(w)) for w in want]


def test_port_server_schedules_like_the_jax_server(world):
    """Admission through prefill changes no event, timestamp order or slot
    position: the schedule is the reference server's."""
    jreqs, jserver, _ = _serve(jserve, world.jcfg, world.jp, world.prompts)
    treqs, tserver, _ = _serve(tserve, world.tcfg, world.tp, world.prompts,
                               device="cpu")
    assert jserver.events == tserver.events
    assert jserver.slot_pos.tolist() == tserver.slot_pos.tolist()
    for r in treqs:
        assert r.t_done >= r.t_first >= r.t_admit


def test_each_admission_runs_the_scan_once_per_layer(world):
    server = tserve.BatchedServer(world.tcfg, SLOTS, MAX_LEN, device="cpu")
    server.load(world.tp)
    before = (kops.ref.calls, dops.ref.calls, fops.ref.calls)
    for rid in range(2):
        assert server.admit(tserve.Request(rid, world.prompts[rid], MAX_NEW))
        assert kops.ref.calls == before[0] + world.tcfg.num_layers * (rid + 1)
    server.step()                       # one decode token: the closed form
    assert kops.ref.calls == before[0] + 2 * world.tcfg.num_layers
    assert (dops.ref.calls, fops.ref.calls) == before[1:]
    assert server.slot_pos.tolist() == [PROMPT_LENS[0] + 1, PROMPT_LENS[1] + 1]


def test_admission_replaces_the_slots_whole_state(world):
    """A slot's rows after admission are the prompt's prefill state, whatever
    the slot held before; the other slot's rows are untouched."""
    server = tserve.BatchedServer(world.tcfg, SLOTS, MAX_LEN, device="cpu")
    server.load(world.tp)
    leaves = lambda t: jax.tree_util.tree_leaves(t)  # noqa: E731
    for leaf in leaves(server.state):
        leaf.normal_()
    other = [leaf[:, 1].clone() for leaf in leaves(server.state)]
    server.admit(tserve.Request(0, world.prompts[0], MAX_NEW))
    _, cache = server.prefill(world.tp, {"tokens": torch.from_numpy(
        world.prompts[0][None])})
    for got, want, kept in zip(leaves(server.state), leaves(cache), other):
        torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=0)
        torch.testing.assert_close(got[:, 1], kept, rtol=0, atol=0)


def test_main_serves_rwkv_smoke_on_cpu(capsys):
    queue = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--requests", "3", "--slots", "2", "--max-new", "4",
                         "--prompt-len", "5"])
    assert all(r.done and len(r.out) == 4 for r in queue)
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


def test_reference_server_departs_from_the_solo_stream(world):
    """The reference's token-by-token admission on a recurrent cache: each
    admitted prompt token also advances the other active slot's state, and
    a reused slot starts from the previous request's state, so all four
    requests depart from their solo streams (the port admits through
    prefill instead)."""
    _, _, seen = _serve(jserve, world.jcfg, world.jp, world.prompts)
    err = [max(float(np.abs(h - w).max()) for w, h in zip(want, seen[rid]))
           for rid, want in enumerate(world.solo)]
    assert all(e > 1.0 for e in err), err
