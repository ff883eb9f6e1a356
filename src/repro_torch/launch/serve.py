"""Batched serving loop (PyTorch twin of ``repro.launch.serve``):
continuous batching over prefill and decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --requests 8 --max-new 32              # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --smoke --device cpu                   # plain versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --device cpu                   # a recurrent model
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --smoke --device cpu   # Mamba/attn/MoE
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-236b --smoke --device cpu       # MLA, dense prefix

A request queue, a decode batch with in-flight slot reuse (a finished
request's slot is refilled from the queue) and greedy sampling.  Every decode
step runs with **per-slot cache positions**: each slot writes and attends at
its own depth, so slots at different depths share one batch.  The loop's
admit/step/finish order, its per-slot position vectors and its event log are
the reference server's, so the virtual scheduler in ``repro.serve_sim``
stays its model.  The KV cache lives on the device and is written in place.

A VLM (internvl2-2b) is served text-only, as the reference's server serves
it: requests carry no image.  A prompt behind a modality prefix, and an
enc-dec's frames, go through the api's ``prefill`` and ``decode_step``
(``launch/steps.make_prefill_step`` and ``make_serve_step``); ``main``
refuses the enc-dec families, as the reference's does.

Admission differs by model.  An attention model is prefilled token by token
through the batch's decode step, as in the reference: the other slots decode
token 0 at their own next position, which is overwritten later.  A model with
recurrent state (RWKV, Mamba, the Jamba hybrid) cannot take that: each such
step would advance every other slot's state, and a reused slot would keep the
previous request's.  So its prompt is prefilled alone, as a (1, L) batch, and
the returned cache is written into the slot's rows: a recurrent state whole,
an attention cache of the prompt's L positions into the slot's first L
(later positions are never read: a row attends up to its own ``pos``).  Each
request then gets the stream the model functions define for it alone
(``prefill``, then ``decode_step``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import get_arch
from repro_torch.core.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import api
from repro_torch.models.layers import copy_into_leading, tree_map


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    # per-request serving metrics (perf_counter timestamps)
    t_arrive: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_arrive

    @property
    def tpot(self) -> float:
        n = len(self.out)
        return (self.t_done - self.t_first) / (n - 1) if n > 1 else 0.0


class BatchedServer:
    """Slot-based continuous batching (decode-centric).

    ``decode_fn(params, state, tokens, pos) -> (logits, state)`` defaults to
    the port's decode step on ``device`` (``cuda`` unless the caller asks
    for the CPU); tests inject a stub to exercise the scheduling loop.
    ``tokens`` and ``pos`` reach it as int32 tensors on ``device``; ``pos``
    is always the per-slot position vector.  When ``cfg`` has a layer whose
    mixer is not attention, ``admit`` prefills the prompt alone and writes
    its cache into the slot's rows.
    """

    def __init__(self, cfg, batch_slots: int, max_len: int,
                 decode_fn: Optional[Callable] = None, state=None,
                 record_events: bool = False, device="cuda"):
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.record_events = record_events
        self.device = resolve_device(device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)
        if decode_fn is None:
            self.state = api.allocate_decode_state(cfg, batch_slots, max_len,
                                                   self.device)
            self.decode = steps_lib.make_serve_step(cfg)
        else:
            self.state = state
            self.decode = decode_fn
        recurrent = cfg is not None and \
            any(kind != "attn" for kind in cfg.layer_kinds())
        self.prefill = steps_lib.make_prefill_step(cfg) if recurrent else None
        self.params = None
        # ("admit", rid) | ("step", rids) | ("finish", rid); recorded only
        # with record_events, unbounded otherwise
        self.events: List[Tuple] = []

    def load(self, params):
        self.params = params

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _pos_vector(self, slot: int, pos: int) -> np.ndarray:
        """Per-slot positions: every slot keeps its own write index; only
        ``slot`` is overridden (prefill walks it through the prompt)."""
        vec = self.slot_pos.copy()
        vec[slot] = pos
        return vec

    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot: alone through ``prefill`` for
        a recurrent model, else token by token.

        A recurrent model's prompt must be shorter than ``max_len``: its
        attention cache is copied whole into the slot, so a longer one has
        no room (``ValueError``, raised before a slot is taken).  Token-by-
        token admission keeps the reference's behaviour there: positions
        past the end are clamped to the last one."""
        if self.prefill is not None and len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens does "
                f"not fit a slot of max_len {self.max_len} (a prompt must "
                "leave room for at least one generated token)")
        try:
            slot = self.slot_req.index(None)
        except ValueError:
            return False
        self.slot_req[slot] = req
        req.t_admit = time.perf_counter()
        if self.record_events:
            self.events.append(("admit", req.rid))
        if self.prefill is not None:
            prompt = self._tensor(np.asarray(req.prompt, np.int32)[None])
            _, cache = self.prefill(self.params, {"tokens": prompt})
            _write_cache_into_slot(self.state, cache, slot)
        else:
            for pos, tok in enumerate(req.prompt):
                tokens = np.zeros((self.slots,), np.int32)
                tokens[slot] = tok
                _, self.state = self.decode(
                    self.params, self.state, self._tensor(tokens),
                    self._tensor(self._pos_vector(slot, pos)))
        self.slot_pos[slot] = len(req.prompt)
        return True

    def step(self) -> int:
        """One decode step for every active slot; returns #finished."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.zeros((self.slots,), np.int32)
        for i in active:
            r = self.slot_req[i]
            tokens[i] = r.out[-1] if r.out else r.prompt[-1]
        if self.record_events:
            self.events.append(
                ("step", tuple(sorted(self.slot_req[i].rid for i in active))))
        logits, self.state = self.decode(
            self.params, self.state, self._tensor(tokens),
            self._tensor(self.slot_pos.copy()))
        # greedy: argmax on the device (first maximum, as np.argmax), one
        # small copy to the host
        nxt = torch.as_tensor(logits).argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        finished = 0
        for i in active:
            r = self.slot_req[i]
            if not r.out:
                r.t_first = now
            r.out.append(int(nxt[i]))
            self.slot_pos[i] += 1
            if len(r.out) >= r.max_new or self.slot_pos[i] >= self.max_len - 1:
                r.done = True
                r.t_done = now
                self.slot_req[i] = None
                if self.record_events:
                    self.events.append(("finish", r.rid))
                finished += 1
        return finished


def _write_slot(dst: torch.Tensor, src: torch.Tensor, slot: int) -> None:
    """``dst[:, slot] = src[:, 0]`` in place; both are (periods, batch, ...).
    A leaf shorter than the slot's (an attention cache of the prompt's L
    positions, (periods, 1, Hkv, L, hd), in a slot of max_len) fills the
    leading part of each axis."""
    copy_into_leading(dst[:, slot], src[:, 0])


def _write_cache_into_slot(state, cache, slot: int) -> None:
    """A one-row prefill ``cache`` into ``state``'s rows of ``slot``, in
    place: the stacked periods' leaves (periods, batch, ...) and the prefix
    blocks' (batch, ...), each given a period axis of one."""
    tree_map(lambda dst, src: _write_slot(dst, src, slot),
             state["periods"], cache["periods"])
    if "prefix" in cache:
        tree_map(lambda dst, src: _write_slot(dst[None], src[None], slot),
                 state["prefix"], cache["prefix"])


def serve_summary(requests: List[Request]) -> str:
    """Measured TTFT/TPOT percentiles."""
    done = [r for r in requests if r.done]
    if not done:
        return "no finished requests"
    ttft = np.array([r.ttft for r in done])
    tpot = np.array([r.tpot for r in done if len(r.out) > 1])
    lines = [f"  TTFT p50/p99 = {np.percentile(ttft, 50) * 1e3:.0f}/"
             f"{np.percentile(ttft, 99) * 1e3:.0f} ms"]
    if tpot.size:
        lines.append(f"  TPOT p50/p99 = {np.percentile(tpot, 50) * 1e3:.2f}/"
                     f"{np.percentile(tpot, 99) * 1e3:.2f} ms")
    return "\n".join(lines)


def run(server: BatchedServer, queue: List[Request]) -> int:
    """Admit from the queue and step until every request is done; returns
    the number of decode steps."""
    pending = list(queue)
    steps = 0
    while not all(r.done for r in queue):
        while pending and server.admit(pending[0]):
            pending.pop(0)
        server.step()
        steps += 1
    return steps


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    if cfg.family in ("audio", "encdec", "convnet"):
        raise SystemExit("serve.py targets decoder-only archs")

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init_params(gen, cfg)
    server = BatchedServer(cfg, args.slots, args.max_len, device=device)
    server.load(params)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    queue = [Request(i, rng.integers(0, cfg.vocab_size,
                                     size=(args.prompt_len,)),
                     args.max_new, t_arrive=t0)
             for i in range(args.requests)]
    steps = run(server, queue)
    wall = time.perf_counter() - t0
    toks = sum(len(r.out) for r in queue)
    print(f"served {len(queue)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s, {steps} decode steps) on {device}")
    print(serve_summary(queue))
    return queue


if __name__ == "__main__":
    main()
