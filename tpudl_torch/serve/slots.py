"""Slot-based continuous batch decoding on a fixed-geometry KV cache.

Port of ``tpudl/serve/slots.py``: the LM serving engine. One decode-step
program of static geometry ``(slots, cache_len, temperature)`` serves a
churning request mix. Requests are INSERTED into free slots (the prompt
runs through a batch-1 decode step on a fresh row cache, then the whole
row is written into the slot cache at a slot index held on the device, a
write that also wipes the slot's previous occupant) and EVICTED by host
bookkeeping plus one device flag, so the programs never change shape.

Each program is a function over the engine's state tensors (the cache,
``tok``, ``pos``, ``steps`` and the live flags all stay on the device;
see ``TinyCausalLM._slot_step_program`` and ``_slot_prefill_program``).
On the card each is captured once as a CUDA graph
(:class:`~tpudl_torch.compile.graphs.BoundGraph`): a :meth:`SlotDecoder.
step` is one graph replay and one device→host copy of the ``[S]`` next
tokens, and an insert replays the batch-1 prefill graph once per prompt
token, then the insert graph. After warm-up, churn captures no new graph
(``SlotDecoder.captures``; the counterpart of tpudl's zero-retrace pin).
On the CPU the same functions run eagerly. A capture or replay that fails
on the card raises; nothing falls back. With the program store armed
(``TPUDL_COMPILE_AOT``) every program runs through it, as tpudl's
``_call`` does: the store records each signature in its manifest and
counts hits and misses.

Each slot's greedy stream equals a serial batch-1 ``generate`` of the
same prompt: rows are independent in every product and the per-slot mask
hides dead cache lanes. With ``temperature > 0`` each slot draws from its
own ``torch.Generator``, seeded from its request's ``rng`` (an int, or a
generator on the engine's device), in the order ``generate(generator=)``
draws, outside the graph on the graph's logits; tpudl's JAX key streams
are not reproduced. Decoding runs in full f32 (``device.full_f32``).

``tp=True`` over a local mesh decodes tensor-parallel (tpudl's
``mesh``/``tp``): the module is laid out over the mesh's first row of
cards (``shard_params``), the slot and row caches are split over heads,
and every program runs over that row. Where the row holds more than one
distinct card the programs run eagerly: one CUDA graph is captured on one
card.

The engine is single-consumer (the server thread); no lock.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from tpudl_torch.compile import store as _store
from tpudl_torch.compile.buckets import resolve_ladder
from tpudl_torch.compile.graphs import BoundGraph
from tpudl_torch.device import full_f32, resolve_device
from tpudl_torch.obs import metrics as _metrics
from tpudl_torch.serve import reqtrace as _reqtrace
from tpudl_torch.serve.queue import AdmissionError, Evicted
from tpudl_torch.zoo.transformer import TinyCausalLM, _pick, _shards, arch_of

__all__ = ["SlotDecoder"]

# copied from tpudl/serve/slots.py:_env_int
def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SlotDecoder:
    """Continuous-batching decode engine for one model.

    ``model`` is a :class:`~tpudl_torch.zoo.transformer.TinyCausalLM`. With
    ``params`` (tpudl's numpy param pytree) the engine loads them into a
    module of ``model``'s architecture on ``device`` (default ``"cuda"``);
    without, it decodes with ``model`` itself, on its device. ``slots``
    defaults to ``TPUDL_SERVE_SLOTS`` (8); ``cache_len`` (the fixed
    per-slot KV length) to the model's ``max_len``. ``prompt_buckets``
    resolves the ladder that :meth:`rung_for` reads, kept for parity with
    tpudl: it shapes only the rung that method reports, since the prefill
    runs the real prompt length through the one batch-1 graph, so it
    changes no program and no result here (nor, with the program store
    armed, any key). ``tp=True`` with a local ``mesh``
    decodes tensor-parallel over the mesh's first row (the module given
    with ``params`` loads on its first card; a module given alone is laid
    out in place); ``mesh`` without ``tp`` changes nothing, as in tpudl,
    whose slot programs take the mesh only for ``tp``.

    ``programs`` maps each program's key to it and ``captures`` counts the
    CUDA graphs captured (0 on the CPU)."""

    def __init__(self, model, params=None, *, slots: int | None = None,
                 cache_len: int | None = None, temperature: float = 0.0,
                 prompt_buckets=True, mesh=None, tp: bool = False,
                 device=None):
        cards = model._decode_cards(mesh, tp)
        if params is not None:
            home = cards[0] if cards else resolve_device(device or "cuda")
            model = TinyCausalLM.from_jax_params(
                params, **arch_of(model), device=home)
        elif device is not None and resolve_device(device) != model.device:
            raise ValueError(
                f"device={device!r} but the model lives on {model.device}; "
                "pass params= to load it there")
        if cards:
            model.shard_params(mesh.row(0))
        self.model = model
        self.mesh, self.tp = mesh, bool(tp)
        # one CUDA graph runs on one card
        self._graphs = len(set(cards or [model.device])) == 1
        self.device = model.device
        self.slots = (int(slots) if slots is not None
                      else _env_int("TPUDL_SERVE_SLOTS", 8))
        self.cache_len = int(cache_len if cache_len is not None
                             else model.max_len)
        self.temperature = float(temperature)
        self._ladder = resolve_ladder(prompt_buckets)
        s, dev = self.slots, self.device
        with torch.inference_mode():
            self._cache = model.init_cache(s, self.cache_len, mesh=mesh,
                                           tp=tp)
            self._row = model.init_cache(1, self.cache_len, mesh=mesh,
                                         tp=tp)
            ints = dict(dtype=torch.int64, device=dev)
            self._tok = torch.zeros(s, **ints)
            self._pos = torch.zeros(s, **ints)
            self._steps = torch.zeros(s, **ints)
            self._live = torch.zeros(s, **ints)
            self._prompt = torch.zeros(self.cache_len, **ints)
            self._ppos = torch.zeros((), **ints)
            self._slot = torch.zeros(1, **ints)
            self._logits = torch.zeros(s, model.vocab, device=dev)
            self._first = torch.zeros(1, model.vocab, device=dev)
            self._hidden = torch.zeros(1, model.dim, device=dev)
        self._gens: list = [None] * s
        self.programs: dict = {}
        # per-slot occupant: {"request", "tokens": [ints], "trace"}
        # or None
        self._meta: list[dict | None] = [None] * s
        # decode-cadence stamp stride, resolved once (the step loop is
        # the hot path — no env read per token)
        self._trace_cadence = _reqtrace.decode_cadence()

    # -- host-side bookkeeping --------------------------------------------
    # copied from tpudl/serve/slots.py:SlotDecoder.free
    def free(self) -> list:
        return [s for s, m in enumerate(self._meta) if m is None]

    # copied from tpudl/serve/slots.py:SlotDecoder.active
    def active(self) -> list:
        return [s for s, m in enumerate(self._meta) if m is not None]

    # copied from tpudl/serve/slots.py:SlotDecoder.occupants
    def occupants(self) -> list:
        """``[(slot, request), ...]`` for every occupied slot — the
        server's mid-decode deadline sweep walks this."""
        return [(s, m["request"]) for s, m in enumerate(self._meta)
                if m is not None]

    # copied from tpudl/serve/slots.py:SlotDecoder.occupancy
    def occupancy(self) -> float:
        return len(self.active()) / max(self.slots, 1)

    # copied from tpudl/serve/slots.py:SlotDecoder.rung_for
    def rung_for(self, plen: int, max_new: int) -> int:
        """Padded prompt length for one admission: bucketed UP the
        ladder but never past what the fixed cache can hold alongside
        ``max_new`` decode steps (past the cap the exact length is
        used — honest, one extra program for an outlier)."""
        plen, max_new = int(plen), int(max_new)
        if plen + max_new > self.cache_len:
            raise ValueError(
                f"prompt ({plen}) + max_new ({max_new}) exceeds the "
                f"slot cache length {self.cache_len}")
        if self._ladder is None:
            return plen
        return max(plen, min(self._ladder.pick(plen),
                             self.cache_len - max_new))

    # -- the programs --------------------------------------------------------
    def _key(self, name: str) -> tuple:
        """The key of program ``name`` in ``programs``: the decode step
        of this geometry, the batch-1 prefill step, or the insert."""
        return {"step": ("slot_step", self.slots, self.cache_len,
                         self.temperature),
                "prefill": ("slot_prefill", self.cache_len),
                "insert": ("slot_insert", self.slots, self.cache_len)}[name]

    def _program(self, name: str) -> BoundGraph:
        """The engine's program ``name``, built at its first use."""
        key = self._key(name)
        prog = self.programs.get(key)
        if prog is not None:
            return prog
        m, small = self.model, (self._tok, self._pos, self._steps,
                                self._live, self._ppos)
        par = dict(mesh=self.mesh, tp=self.tp)
        if name == "step":
            fn = m._slot_step_program(self.temperature, **par)
            state = (self._cache, self._tok, self._pos, self._steps,
                     self._live, self._logits)
        else:
            step, finish = m._slot_prefill_program(**par)
            if name == "prefill":
                fn, state = step, (self._row, self._prompt, self._ppos,
                                   self._hidden)
            else:
                fn, state = finish, (self._row, self._cache, self._hidden,
                                     self._ppos, self._slot, self._tok,
                                     self._pos, self._steps, self._live,
                                     self._first)
        prog = self.programs[key] = BoundGraph(fn, state, small,
                                               graphs=self._graphs)
        return prog

    def _call(self, name: str) -> None:
        """Run program ``name``: through the program store when it is
        armed (tpudl's ``_call``), else directly."""
        prog = self._program(name)
        if _store.aot_enabled():
            _store.get_program_store().run_bound(prog)
        else:
            prog()

    @contextlib.contextmanager
    def _running(self):
        """Where every program runs: inference mode, full f32, and on the
        card the engine's own device as the current one."""
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda" else contextlib.nullcontext())
        with torch.inference_mode(), full_f32(), on_card:
            yield

    @property
    def captures(self) -> int:
        """The CUDA graphs this engine captured (0 on the CPU)."""
        return sum(p.graph is not None for p in self.programs.values())

    def warm(self) -> int:
        """Build every program now; on the card, capture each one's graph.
        Returns the number of programs made ready (the graphs captured on
        the card; the programs built on the CPU) — the in-process
        counterpart of tpudl's ``precompile_serve``, which calls it; with
        the store armed each program is readied through it (recorded in
        its manifest; the engine holds it). With every slot occupied the
        insert program is left to the next insert: its warm-up run writes
        the row cache into slot ``_slot``, which must then be a free
        one."""
        def ready():
            return (self.captures if self._graphs
                    and self.device.type == "cuda" else len(self.programs))

        before = ready()
        free = self.free()
        store = (_store.get_program_store() if _store.aot_enabled()
                 else None)
        with self._running():
            for name in ("step", "prefill") + (("insert",) if free else ()):
                if name == "insert":
                    self._slot.fill_(free[0])
                if store is not None:
                    store.ready_bound(self._program(name))
                else:
                    self._program(name).ready()
        return ready() - before

    def _generator(self, rng) -> torch.Generator:
        """A sampled slot's stream: ``rng`` itself when it is a
        ``torch.Generator``, else one on the engine's device seeded with
        ``rng`` (0 when None)."""
        if isinstance(rng, torch.Generator):
            return rng
        if rng is not None and not isinstance(rng, (int, np.integer)):
            raise TypeError(
                f"rng must be an int seed or a torch.Generator, got "
                f"{type(rng).__name__}")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng or 0))
        return gen

    # -- the three verbs ---------------------------------------------------
    def insert(self, request) -> int:
        """Prefill ``request``'s prompt into a free slot; returns the
        slot index with the first token already decoded (the request's
        TTFT moment — the server observes it). Raises the typed
        :class:`AdmissionError` (``slots_full``) when no slot is free:
        direct engine users get the same typed answer the queue gives."""
        free = self.free()
        if not free:
            raise AdmissionError(
                f"all {self.slots} decode slots occupied; raise "
                f"TPUDL_SERVE_SLOTS or queue the request",
                reason="slots_full")
        slot = free[0]
        trace = getattr(request, "trace", None)
        if trace is not None:
            trace.stamp("slot_insert")
        plen = int(request.prompt.shape[1])
        if plen < 1:
            raise ValueError("a prompt must hold >= 1 token")
        self.rung_for(plen, request.max_new)   # the typed overflow check
        if trace is not None:
            trace.stamp("rung_pack")
        gen = (self._generator(request.rng) if self.temperature > 0
               else None)
        with self._running():
            self._prompt[:plen].copy_(torch.from_numpy(
                request.prompt[0].astype(np.int64)))
            self._ppos.zero_()
            for layer in self._row:
                for t in (*_shards(layer["k"]), *_shards(layer["v"])):
                    t.zero_()
            self._slot.fill_(slot)
            for _ in range(plen):
                self._call("prefill")
            self._call("insert")
            if gen is not None:
                self._tok[slot:slot + 1].copy_(
                    _pick(self._first, self.temperature, gen))
            first_tok = int(self._tok[slot])
        if trace is not None:
            trace.stamp("first_token")
        self._gens[slot] = gen
        self._meta[slot] = {"request": request, "tokens": [first_tok],
                            "trace": trace}
        _metrics.counter("serve.inserts").inc()
        return slot

    def step(self) -> int:
        """One decode step for EVERY active slot through the engine's one
        step program; returns the number of tokens emitted (0 = nothing
        active, no dispatch). Inactive slots ride along as dead lanes
        (their writes land at their frozen position and are overwritten
        by the next insert's full-row write)."""
        active = self.active()
        if not active:
            return 0
        with self._running():
            self._call("step")
            if self.temperature > 0:
                for s in active:
                    self._tok[s:s + 1].copy_(_pick(
                        self._logits[s:s + 1], self.temperature,
                        self._gens[s]))
            nxt = self._tok.cpu().numpy()
        cad = self._trace_cadence
        for s in active:
            meta = self._meta[s]
            meta["tokens"].append(int(nxt[s]))
            trace = meta["trace"]
            if trace is not None:
                n = len(meta["tokens"])
                if n % cad == 0:
                    trace.stamp(f"decode_{n}")
        _metrics.counter("serve.steps").inc()
        _metrics.counter("serve.tokens").inc(len(active))
        _metrics.gauge("serve.batch_occupancy").set(self.occupancy())
        return len(active)

    def _vacate(self, slot: int) -> dict:
        """Free ``slot``: its host record goes and its live flag drops on
        the device, so its position stops advancing."""
        meta = self._meta[slot]
        self._meta[slot] = None
        self._gens[slot] = None
        with torch.inference_mode():
            self._live[slot] = 0
        return meta

    def evict(self, slot: int, error: BaseException | None = None):
        """Free ``slot`` NOW (host bookkeeping and its live flag — the
        next insert's full-row write retires the stale cache state).
        Returns the evicted request; when ``error`` is given the request
        is failed with it (typed: deadline shed, cancel), else the caller
        owns the disposition (e.g. requeue for a retry)."""
        if self._meta[int(slot)] is None:
            raise KeyError(f"slot {slot} is not occupied")
        meta = self._vacate(int(slot))
        _metrics.counter("serve.evictions").inc()
        req = meta["request"]
        trace = meta.get("trace")
        if trace is not None:
            trace.stamp("evict")
        if error is not None:
            req.fail(error)
        return req

    # copied from tpudl/serve/slots.py:SlotDecoder.evict_all
    def evict_all(self, error: BaseException | None = None) -> list:
        """Evict every occupant (supervised-retry reset / teardown)."""
        return [self.evict(s, error) for s in self.active()]

    def pop_completed(self) -> list:
        """Harvest ``[(request, tokens), ...]`` for every slot whose
        occupant has emitted ``max_new`` tokens, freeing the slots.
        Completion is NOT an eviction: ``serve.evictions`` counts only
        early removals."""
        out = []
        for s in self.active():
            meta = self._meta[s]
            req = meta["request"]
            if len(meta["tokens"]) >= req.max_new:
                self._vacate(s)
                out.append((req, np.asarray(meta["tokens"],
                                            dtype=np.int32)))
        return out

    # copied from tpudl/serve/slots.py:SlotDecoder.cancel
    def cancel(self, request) -> bool:
        """Evict ``request`` mid-decode, failing it typed
        :class:`Evicted`; ``False`` when it occupies no slot."""
        for s, req in self.occupants():
            if req is request:
                self.evict(s, Evicted("request cancelled mid-decode"))
                return True
        return False
