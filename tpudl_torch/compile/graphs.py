"""The programs that the executor and the program store run: a function
over M microbatches as one CUDA graph (:class:`FusedGraph`), its plain
version on the CPU (:class:`PlainProgram`), and a program that runs in
place over fixed state tensors (:class:`BoundGraph`, the serve engine's).

Every graph is captured through the port's one capture path,
:func:`tpudl_torch.cuda_ops.capture_graph`. A capture or replay that fails
raises; nothing falls back to the eager function.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from tpudl_torch.testing import tsan as _tsan

__all__ = ["FusedGraph", "PlainProgram", "BoundGraph", "as_outputs",
           "fused_plain"]


def as_outputs(result, n_out: int) -> tuple:
    """``fn``'s result as a tuple of ``n_out`` tensors (a host function's
    numpy outputs are wrapped without a copy)."""
    if not isinstance(result, (tuple, list)):
        result = (result,)
    if len(result) != n_out:
        raise ValueError(f"fn returned {len(result)} outputs, expected "
                         f"{n_out}")
    return tuple(torch.from_numpy(np.asarray(r))
                 if isinstance(r, np.ndarray) else r for r in result)


def fused_plain(run_fn: Callable, group, n_out: int) -> tuple:
    """What a fused dispatch computes, on the CPU: M plain calls and a
    concatenation per output (the plain version the graph is held
    against)."""
    outs = [as_outputs(run_fn(*g[0]), n_out) for g in group]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(n_out))


class FusedGraph:
    """``fn`` over M microbatches as ONE CUDA graph — the port of tpudl's
    ``_fused_wrapper``, whose ``lax.scan`` program runs M stacked
    microbatches per dispatch. The graph reads a static ``(M, B, ...)``
    input per column and writes ``(M·B, ...)`` outputs. A fused dispatch
    (:meth:`run`) copies the group's pinned microbatches into the static
    input, replays the graph and clones the outputs, all under the
    graph's lock and after the last run's clones on any stream, so that
    two threads transforming with one stage never share a static buffer.

    The first run captures through ``cuda_ops.capture_graph``, which runs
    ``fn`` once on one microbatch outside the capture first, and captures
    in ``thread_local`` mode, so that the prepare pool may pin host memory
    meanwhile. A capture or replay that
    fails raises. Launch counts of the port's kernels are recorded at
    capture and added at every replay. Capture and replay run under
    ``torch.inference_mode``."""

    def __init__(self, run_fn: Callable, m: int, like, n_out: int, device):
        self._fn = run_fn
        self._m = int(m)
        self._n_out = n_out
        with torch.inference_mode():
            self.static_in = [torch.empty((self._m, *t.shape),
                                          dtype=t.dtype, device=device)
                              for t in like]
        self.static_out: tuple = ()
        self.graph = None
        self.launches: dict = {}
        self._lock = _tsan.named_lock("compile.graphs.fused")
        self._done = None  # event after the last run's clones

    def _capture(self, warm: bool = True):
        from tpudl_torch import cuda_ops

        def run():
            outs = [as_outputs(self._fn(
                *(x[i] for x in self.static_in)), self._n_out)
                for i in range(self._m)]
            self.static_out = tuple(torch.cat([o[j] for o in outs])
                                    for j in range(self._n_out))
        run.__wrapped__ = self._fn   # what the graph runs, to traceck

        def warmup():
            if warm:
                self._fn(*(x[0] for x in self.static_in))

        # tpudl: ignore[jit-cache-churn] — one capture a graph: run()
        # and warmup() are made here only while self.graph is None (the
        # caller holds the graph's lock), so no identity churns
        self.graph, self.launches = cuda_ops.capture_graph(
            run, self.static_in[0].device, warmup=warmup)
        self._fn = None  # captured: the graph no longer calls fn

    def _load(self, group):
        for j, x in enumerate(self.static_in):
            for i, g in enumerate(group):
                x[i].copy_(g[0][j], non_blocking=True)

    def ready(self, group, warm: bool = True):
        """Capture now, over ``group``'s values, without a replay (the
        program store's capture). ``warm=False`` skips the warm-up run:
        the caller just ran ``fn`` eagerly on these shapes."""
        with self._lock, torch.inference_mode():
            if self.graph is None:
                self._load(group)
                self._capture(warm)

    def run(self, group, report) -> tuple:
        """One fused dispatch of ``group`` (M prepared microbatches) on
        the current stream: its outputs, cloned off the graph's."""
        from tpudl_torch import cuda_ops

        stream = torch.cuda.current_stream(self.static_in[0].device)
        with self._lock, torch.inference_mode():
            if self._done is not None:
                stream.wait_event(self._done)
            with report.stage("h2d"):
                self._load(group)
            with report.stage("dispatch"):
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                cuda_ops.count_replay(self.launches)
                out = tuple(o.clone() for o in self.static_out)
            self._done = torch.cuda.Event()
            self._done.record(stream)
            return out

    def release(self):
        """Wait until no replay of this graph is pending, so that its
        memory pool can go back to the allocator."""
        with self._lock:
            if self._done is not None:
                # tpudl: ignore[lock-held-blocking] — the wait IS the
                # release: under the graph's lock no replay can start
                # between it and the pool's return (an evicted graph
                # only; never on the dispatch path)
                self._done.synchronize()


class PlainProgram:
    """A program on the CPU: the plain function (``m`` microbatches: ``m``
    calls and a concatenation, as :func:`fused_plain`)."""

    graph = None

    def __init__(self, run_fn, m: int, n_out: int):
        self._fn = run_fn
        self._m = int(m)
        self._n_out = n_out

    def ready(self, group, warm=True):
        pass

    def run(self, group, report) -> tuple:
        if self._m == 1:
            return as_outputs(self._fn(*group[0][0]), self._n_out)
        return fused_plain(self._fn, group, self._n_out)

    def release(self):
        pass


class BoundGraph:
    """One program that runs IN PLACE over fixed state tensors (the serve
    engine's step, prefill and insert programs): ``fn(*state)`` run
    eagerly on the CPU, and on the card captured at its first call as one
    CUDA graph that every later call replays, through
    ``cuda_ops.capture_graph``. Its warm-up run changes state the graph
    also changes; the small tensors in ``restore`` are put back after it,
    and what it wrote into the caches the first replay writes again,
    value for value. ``graphs=False`` runs it eagerly on the card too."""

    def __init__(self, fn, state, restore, graphs: bool = True):
        self.fn = fn
        self.state = state
        self._restore = restore
        self.device = state[-1].device
        self.graphs = graphs and self.device.type == "cuda"
        self.graph = None
        self.launches: dict = {}
        self._done = None   # event after the last replay

    def ready(self) -> None:
        """Capture the graph now, if this program is due one."""
        if not self.graphs or self.graph is not None:
            return
        from tpudl_torch import cuda_ops

        saved = [t.clone() for t in self._restore]

        def warmup():
            self.fn(*self.state)
            for t, s in zip(self._restore, saved):
                t.copy_(s)

        def run():
            self.fn(*self.state)
        run.__wrapped__ = self.fn    # what the graph runs, to traceck

        # tpudl: ignore[jit-cache-churn] — one capture a program: ready()
        # returns early once self.graph is set, so run() is made once
        self.graph, self.launches = cuda_ops.capture_graph(
            run, self.device, warmup=warmup)

    def __call__(self):
        if not self.graphs:
            self.fn(*self.state)
            return
        from tpudl_torch import cuda_ops

        self.ready()
        self.graph.replay()
        cuda_ops.count_replay(self.launches)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(self.device))

    def release(self):
        """Wait until no replay of this graph is pending."""
        if self._done is not None:
            self._done.synchronize()
