"""Multi-model serve registry.

Port of ``tpudl/serve/registry.py``. Registration is where time to first
token is won: ``add_model`` builds the model's
:class:`~tpudl_torch.serve.slots.SlotDecoder` and, with ``warm=True``,
makes every program of its serve loop ready at once — on the card it
captures the decode-step graph, the batch-1 prefill graph and the insert
graph (``warm_signatures`` counts them, ``warm_s`` times them). With the
program store armed (``TPUDL_COMPILE_AOT``) it does so through
``TinyCausalLM.precompile_serve``, as tpudl's registry does: the graphs
land in the store's table and their signatures in its manifest. Every
prompt length shares the one prefill graph, so ``prompt_rungs=`` (which
prefill programs tpudl compiles) is accepted and changes nothing.

One instance lock guards the name→entry map; the ``serve.models`` gauge
publishes outside it.
"""

from __future__ import annotations

import time

from tpudl_torch.compile.store import aot_enabled
from tpudl_torch.obs import metrics as _metrics
from tpudl_torch.serve.slots import SlotDecoder
from tpudl_torch.testing import tsan as _tsan

__all__ = ["ModelEntry", "ModelRegistry"]


# copied from tpudl/serve/registry.py:ModelEntry
class ModelEntry:
    """One registered model: its engine plus warm-start forensics.
    ``tokenizer`` is set for text-serving entries (``add_generator``)
    so the request path can encode prompts / decode completions with
    the exact vocab the model was trained against."""

    __slots__ = ("name", "model", "params", "engine",
                 "warm_signatures", "warm_s", "tokenizer")

    def __init__(self, name: str, model, params, engine: SlotDecoder,
                 warm_signatures: int, warm_s: float, tokenizer=None):
        self.name = name
        self.model = model
        self.params = params
        self.engine = engine
        self.warm_signatures = warm_signatures
        self.warm_s = warm_s
        self.tokenizer = tokenizer


class ModelRegistry:
    """Name → :class:`ModelEntry` map shared by one server."""

    def __init__(self):
        self._lock = _tsan.named_lock("serve.registry")
        self._entries: dict[str, ModelEntry] = {}

    def add_model(self, name: str, model, params=None, *,
                  slots: int | None = None,
                  cache_len: int | None = None,
                  temperature: float = 0.0, prompt_buckets=True,
                  prompt_rungs=None, mesh=None, tp: bool = False,
                  warm: bool = True, tokenizer=None,
                  device=None) -> ModelEntry:
        """Build the engine for ``model`` (with ``params``, tpudl's param
        pytree, loaded on ``device``; see :class:`SlotDecoder`) and, with
        ``warm=True``, make its serve programs ready now (through
        ``precompile_serve`` and the program store when it is armed).
        ``prompt_buckets`` only shapes what ``SlotDecoder.rung_for``
        reports; the prefill ignores it (see :class:`SlotDecoder`)."""
        engine = SlotDecoder(model, params, slots=slots,
                             cache_len=cache_len, temperature=temperature,
                             prompt_buckets=prompt_buckets, mesh=mesh,
                             tp=tp, device=device)
        warm_n, warm_s = 0, 0.0
        if warm:
            t0 = time.perf_counter()
            if aot_enabled():
                warm_n = engine.model.precompile_serve(
                    slots=engine.slots, cache_len=engine.cache_len,
                    prompt_rungs=prompt_rungs,
                    temperature=engine.temperature, mesh=mesh, tp=tp,
                    engine=engine)
            else:
                warm_n = engine.warm()
            warm_s = time.perf_counter() - t0
        entry = ModelEntry(str(name), model, params, engine, warm_n,
                           warm_s, tokenizer=tokenizer)
        with self._lock:
            self._entries[entry.name] = entry
            count = len(self._entries)
        _metrics.gauge("serve.models").set(count)
        return entry

    def add_generator(self, name: str, generator, *,
                      slots: int | None = None,
                      cache_len: int | None = None,
                      warm: bool = True) -> ModelEntry:
        """Register an :class:`~tpudl_torch.ml.lm.LMGenerator` for online
        serving: the stage already binds the model, the weights, the
        sampling temperature, the prompt bucket ladder, its device (a
        mesh's first card, where the stage generates) and the TOKENIZER —
        this unwraps them into :meth:`add_model` and files the tokenizer
        on the entry for the request path."""
        missing = [k for k in ("model", "weights", "tokenizer")
                   if getattr(generator, k, None) is None]
        if missing:
            raise ValueError(
                f"add_generator needs a fully-bound LMGenerator "
                f"(missing {missing})")
        return self.add_model(
            str(name), generator.model, generator.weights,
            slots=slots, cache_len=cache_len,
            temperature=float(generator.temperature),
            prompt_buckets=(generator.promptBuckets
                            if generator.promptBuckets is not None
                            else True),
            warm=warm, tokenizer=generator.tokenizer,
            device=generator._home_device())

    # copied from tpudl/serve/registry.py:ModelRegistry.get
    def get(self, name: str) -> ModelEntry:
        with self._lock:
            try:
                return self._entries[name]
            except KeyError:
                raise KeyError(
                    f"model {name!r} not registered (have: "
                    f"{sorted(self._entries)})") from None

    # copied from tpudl/serve/registry.py:ModelRegistry.names
    def names(self) -> list:
        with self._lock:
            return sorted(self._entries)

    # copied from tpudl/serve/registry.py:ModelRegistry.entries
    def entries(self) -> list:
        with self._lock:
            return list(self._entries.values())
