"""Closed-loop load generation for the serve plane.

Port of ``tpudl/serve/loadgen.py``: ``clients`` threads each keep exactly
one request in flight (the closed-loop discipline — offered load tracks
service rate, so the measured QPS is sustained throughput), and the run
reports sustained QPS, p50/p99 end-to-end latency, TTFT percentiles,
completions, typed rejects and deadline sheds. A rejected submit is an
answer, recorded and moved past; every wait is bounded (``timeout``), so
no client hangs on a dead server.

Each client fires tpudl's ``serve.tick`` fault point before a submit (a
``burst`` rule's count is that many extra fire-and-forget submits in the
same tick) and ``serve.client`` (a ``slow_client`` rule stalls it).
``tenant=`` stamps the requests with an attribution scope
(:mod:`tpudl_torch.obs.attribution`): a string tags every client, a
sequence gives client ``c`` its ``c % len``-th entry.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from tpudl_torch.obs import attribution as _attr
from tpudl_torch.obs.metrics import percentile
from tpudl_torch.serve.queue import AdmissionError
from tpudl_torch.testing import faults as _faults
from tpudl_torch.testing import tsan as _tsan

__all__ = ["run_closed_loop"]


# copied from tpudl/serve/loadgen.py:_percentile
def _percentile(xs: list, q: float):
    # the one shared nearest-rank implementation (tpudl.obs.metrics):
    # the loadgen's ground truth and the obs plane's windows can never
    # disagree by construction
    return percentile(sorted(xs), q)


def run_closed_loop(server, make_prompt, *, requests: int,
                    clients: int = 4, max_new: int = 8,
                    model: str = "default",
                    deadline_s: float | None = None,
                    timeout: float = 120.0,
                    tenant=None) -> dict:
    """Drive ``requests`` total requests through ``server`` with
    ``clients`` closed-loop threads; returns the SLO summary.

    ``make_prompt(i)`` supplies the i-th prompt (ragged lengths are the
    point). The server must already be started (or be run concurrently
    by the caller).

    ``tenant`` stamps the generated requests with an attribution scope:
    a string tags every client with that tenant; a sequence assigns
    client ``c`` the ``c % len``-th entry (``tenant=("a", "b")`` drives
    two tenants). None leaves requests unattributed."""
    # one leaf lock for every tally: the critical sections are scalar
    # bumps/list appends and never nest with the server's locks
    lock = _tsan.named_lock("serve.loadgen")
    counter = [0]
    latencies: list = []
    ttfts: list = []
    rejected = [0]
    shed = [0]
    errors: list = []

    def _next_index():
        with lock:
            i = counter[0]
            counter[0] += 1
            return i

    def _submit(i, wait: bool):
        try:
            req = server.submit(np.asarray(make_prompt(i),
                                           dtype=np.int32),
                                max_new, model=model,
                                deadline_s=deadline_s)
        except AdmissionError:
            with lock:
                rejected[0] += 1
            return
        if not wait:
            return
        try:
            req.result(timeout=timeout)
        except Exception as e:
            with lock:
                if type(e).__name__ in ("DeadlineExceeded", "Evicted"):
                    shed[0] += 1
                else:
                    errors.append(e)
            return
        with lock:
            latencies.append(req.latency_s)
            if req.ttft_s is not None:
                ttfts.append(req.ttft_s)

    def _tenant_of(cid: int):
        if tenant is None or isinstance(tenant, str):
            return tenant
        seq = list(tenant)
        return seq[cid % len(seq)] if seq else None

    def _client(cid: int):
        # the client thread IS the submit thread, so entering the scope
        # here is exactly where ServeRequest captures it
        ctx = (_attr.scope(tenant=_tenant_of(cid))
               if _tenant_of(cid) is not None
               else contextlib.nullcontext())
        with ctx:
            while True:
                i = _next_index()
                if i >= int(requests):
                    return
                burst = _faults.fire("serve.tick", tick=i, client=cid)
                if burst:
                    # the injected spike: that many extra submits in ONE
                    # tick, fire-and-forget — their fate (served or
                    # typed rejected) is what an overload test asserts on
                    for _ in range(int(burst)):
                        _submit(i, wait=False)
                _faults.fire("serve.client", client=cid, i=i)
                _submit(i, wait=True)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=_client, args=(c,),
                                name=f"tpudl-loadgen-{c}", daemon=True)
               for c in range(int(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    completed = len(latencies)
    return {
        "requests": int(requests),
        "clients": int(clients),
        "completed": completed,
        "rejected": rejected[0],
        "deadline_shed": shed[0],
        "wall_s": round(wall, 4),
        "qps": round(completed / wall, 3) if wall > 0 else None,
        "p50_ms": (round(_percentile(latencies, 0.50) * 1000, 3)
                   if latencies else None),
        "p99_ms": (round(_percentile(latencies, 0.99) * 1000, 3)
                   if latencies else None),
        "ttft_p50_s": (round(_percentile(ttfts, 0.50), 4)
                       if ttfts else None),
        "ttft_p99_s": (round(_percentile(ttfts, 0.99), 4)
                       if ttfts else None),
    }
