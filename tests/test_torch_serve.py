"""Port parity for the serving loop: repro_torch.launch.serve against
repro.launch.serve.

The stub-decode scenarios of ``tests/test_serve.py`` and the scripted trace
of ``tests/test_serve_sim.py`` run against the port's server, which must pass
the same per-slot positions and log the same events.  At smoke size the port
serves the same greedy tokens as the JAX server on converted weights.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.launch import serve as jserve
from repro.models import api as japi
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from test_serve_sim import (PARITY_SLOTS, PARITY_TRACE, _run_real_server,
                            _run_virtual_server)


def _stub_server(slots=3, vocab=8, max_len=64):
    calls = []

    def stub(params, state, tokens, pos):
        assert tokens.dtype == torch.int32 and pos.dtype == torch.int32
        calls.append((np.asarray(tokens).copy(), np.asarray(pos).copy()))
        return np.zeros((slots, vocab), np.float32), state

    server = tserve.BatchedServer(cfg=None, batch_slots=slots, max_len=max_len,
                                  decode_fn=stub, record_events=True,
                                  device="cpu")
    server.load(None)
    return server, calls


def test_step_passes_per_slot_positions():
    server, calls = _stub_server(slots=3)
    server.admit(tserve.Request(0, np.array([1, 2, 3], np.int32), max_new=4))
    server.admit(tserve.Request(1, np.array([7], np.int32), max_new=4))
    calls.clear()
    server.step()
    _, pos = calls[-1]
    assert pos.shape == (3,)
    assert list(pos) == [3, 1, 0]
    server.step()
    _, pos = calls[-1]
    assert list(pos) == [4, 2, 0]


def test_admit_prefill_preserves_other_slot_positions():
    server, calls = _stub_server(slots=2)
    server.admit(tserve.Request(0, np.array([1, 2, 3], np.int32), max_new=8))
    server.step()
    calls.clear()
    server.admit(tserve.Request(1, np.array([5, 6], np.int32), max_new=8))
    assert [list(pos) for _, pos in calls] == [[4, 0], [4, 1]]
    assert list(server.slot_pos) == [4, 2]


def test_prefill_targets_only_the_admitted_slot():
    server, calls = _stub_server(slots=2)
    server.admit(tserve.Request(0, np.array([9, 8], np.int32), max_new=2))
    for tokens, _ in calls:
        assert tokens[1] == 0
    assert [t[0] for t, _ in calls] == [9, 8]


def test_events_and_metrics_recorded():
    server, _ = _stub_server(slots=2)
    server.admit(tserve.Request(0, np.array([1], np.int32), max_new=2))
    server.admit(tserve.Request(1, np.array([2, 3], np.int32), max_new=1))
    server.step()
    server.step()
    assert server.events[:3] == [("admit", 0), ("admit", 1), ("step", (0, 1))]
    finished = [e for e in server.events if e[0] == "finish"]
    assert finished == [("finish", 1), ("finish", 0)]


def test_slot_reuse_after_finish():
    server, _ = _stub_server(slots=1)
    r0 = tserve.Request(0, np.array([1], np.int32), max_new=1)
    server.admit(r0)
    server.step()
    assert r0.done and server.slot_req == [None]
    assert r0.t_done >= r0.t_first >= r0.t_admit
    r1 = tserve.Request(1, np.array([2], np.int32), max_new=1)
    assert server.admit(r1)
    server.step()
    assert r1.done


def test_stub_scenarios_match_the_jax_server():
    """One scripted workload through both servers under the stub decode:
    the same (tokens, pos) call sequence and the same event log, idle slots
    decoding token 0 at their stale positions included."""
    logs = []
    for mod, kw in ((jserve, {}), (tserve, {"device": "cpu"})):
        calls = []

        def stub(params, state, tokens, pos):
            calls.append((np.asarray(tokens).tolist(), np.asarray(pos).tolist()))
            return np.zeros((2, 8), np.float32), state

        server = mod.BatchedServer(cfg=None, batch_slots=2, max_len=8,
                                   decode_fn=stub, record_events=True, **kw)
        reqs = [mod.Request(i, np.arange(1, p + 1, dtype=np.int32), m)
                for i, (p, m) in enumerate([(3, 2), (1, 9), (2, 3)])]
        pending = list(reqs)
        while not all(r.done for r in reqs):
            while pending and server.admit(pending[0]):
                pending.pop(0)
            server.step()
        logs.append((calls, server.events, server.slot_pos.tolist()))
    assert logs[0] == logs[1]


def _run_port_server(trace, slots):
    vocab = 8

    def stub(params, state, tokens, pos):
        return np.zeros((slots, vocab), np.float32), state

    server = tserve.BatchedServer(cfg=None, batch_slots=slots, max_len=64,
                                  decode_fn=stub, record_events=True,
                                  device="cpu")
    reqs = [tserve.Request(i, np.ones(p, np.int32), m)
            for i, (_, p, m) in enumerate(trace)]
    pending, steps_taken = [], 0
    while not all(r.done for r in reqs):
        for i, (s, _, _) in enumerate(trace):
            if s == steps_taken:
                pending.append(reqs[i])
        while pending and server.admit(pending[0]):
            pending.pop(0)
        server.step()
        steps_taken += 1
        assert steps_taken < 500, "port server failed to drain the trace"
    return server.events


def test_parity_trace_matches_jax_and_virtual_servers():
    port = _run_port_server(PARITY_TRACE, PARITY_SLOTS)
    assert port == _run_real_server(PARITY_TRACE, PARITY_SLOTS)
    assert port == _run_virtual_server(PARITY_TRACE, PARITY_SLOTS)


def _smoke_cfg(get_arch):
    return dataclasses.replace(get_arch("qwen1.5-0.5b").smoke,
                               param_dtype="float32", compute_dtype="float32")


def test_ragged_batched_decode_matches_solo():
    """Slots at different depths decode as if each request ran alone."""
    cfg = _smoke_cfg(tconfig.get_arch)
    params = tapi.init_params(torch.Generator().manual_seed(0), cfg)
    max_len = 16
    tok_a, tok_b = [3, 11, 4, 8], [6, 2]

    def solo(tokens):
        st = tapi.allocate_decode_state(cfg, 1, max_len, "cpu")
        outs = []
        for p, t in enumerate(tokens):
            lg, st = tapi.decode_step(params, cfg, st,
                                      torch.tensor([t], dtype=torch.int32),
                                      torch.tensor([p], dtype=torch.int32))
            outs.append(lg[0])
        return outs

    solo_a, solo_b = solo(tok_a), solo(tok_b)
    st = tapi.allocate_decode_state(cfg, 2, max_len, "cpu")
    pos = np.zeros(2, np.int32)
    got = {0: [], 1: []}
    ia = ib = 0
    for members in [(0,), (0,), (0, 1), (0, 1)]:   # slot 1 joins 2 steps late
        tokens = np.zeros(2, np.int32)
        if 0 in members:
            tokens[0] = tok_a[ia]
        if 1 in members:
            tokens[1] = tok_b[ib]
        lg, st = tapi.decode_step(params, cfg, st, torch.from_numpy(tokens),
                                  torch.from_numpy(pos.copy()))
        for slot in members:
            got[slot].append(lg[slot])
            pos[slot] += 1
        ia += 0 in members
        ib += 1 in members
    for want, have in zip(solo_a + solo_b, got[0] + got[1]):
        torch.testing.assert_close(have, want, atol=1e-4, rtol=0)


def test_greedy_tokens_match_the_jax_server():
    """Converted weights, the same requests: the same greedy tokens, events
    and final slot positions."""
    _assert_greedy_streams_match(_smoke_cfg(jax_get_arch),
                                 _smoke_cfg(tconfig.get_arch))


def test_greedy_tokens_match_the_jax_server_on_deepseek():
    """deepseek-v2 smoke (MLA, its dense prefix block and MoE periods, at
    the config's capacity factor): the port's server, admitting token by
    token through ``mla_decode``, gives the JAX server's streams."""
    arch = "deepseek-v2-236b"
    jcfg, tcfg = (dataclasses.replace(
        get(arch).smoke, param_dtype="float32", compute_dtype="float32")
        for get in (jax_get_arch, tconfig.get_arch))
    _assert_greedy_streams_match(jcfg, tcfg)


def test_a_prefill_cache_fills_the_prefix_and_the_periods_of_a_slot():
    """A one-row prefill cache goes into the slot's rows of every leaf: the
    stacked periods (periods, batch, ...) and the prefix blocks' (batch,
    ...), a leaf shorter than the slot's filling its leading positions."""
    state = {"prefix": {"blk0": {"ckv": torch.zeros(3, 8, 2)}},
             "periods": {"sub0": {"ckv": torch.zeros(2, 3, 8, 2)}}}
    cache = {"prefix": {"blk0": {"ckv": torch.ones(1, 5, 2)}},
             "periods": {"sub0": {"ckv": torch.full((2, 1, 5, 2), 2.0)}}}
    tserve._write_cache_into_slot(state, cache, 1)
    pre, per = state["prefix"]["blk0"]["ckv"], state["periods"]["sub0"]["ckv"]
    assert pre[1, :5].eq(1).all() and per[:, 1, :5].eq(2).all()
    assert pre.sum() == 10 and per.sum() == 40


def _assert_greedy_streams_match(jcfg, tcfg):
    jparams = japi.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 2, 7)]
    results = []
    for mod, cfg, params, kw in ((jserve, jcfg, jparams, {}),
                                 (tserve, tcfg, tparams, {"device": "cpu"})):
        server = mod.BatchedServer(cfg, 2, 24, record_events=True, **kw)
        server.load(params)
        reqs = [mod.Request(i, p, max_new=6) for i, p in enumerate(prompts)]
        pending = list(reqs)
        while not all(r.done for r in reqs):
            while pending and server.admit(pending[0]):
                pending.pop(0)
            server.step()
        results.append(([r.out for r in reqs], server.events,
                         server.slot_pos.tolist()))
    assert results[0] == results[1]


def test_main_serves_deepseek_smoke_on_cpu(capsys):
    queue = tserve.main(["--arch", "deepseek-v2-236b", "--smoke", "--device",
                         "cpu", "--requests", "3", "--slots", "2",
                         "--max-new", "3", "--prompt-len", "4"])
    assert all(r.done and len(r.out) == 3 for r in queue)
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out


def test_main_smoke_on_cpu(capsys):
    queue = tserve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                         "--requests", "3", "--slots", "2", "--max-new", "4",
                         "--prompt-len", "5"])
    assert all(r.done and len(r.out) == 4 for r in queue)
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
    assert "TTFT p50/p99" in out and "TPOT p50/p99" in out
    assert tserve.serve_summary([]) == "no finished requests"
