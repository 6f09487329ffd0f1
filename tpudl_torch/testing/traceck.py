"""tpudl_torch.testing.traceck — the opt-in recompile-storm sentinel.

Port of ``tpudl/testing/traceck.py``. tpudl counts traces of the
functions handed to ``jax.jit``; the port's counterpart of a trace is a
CUDA-graph capture, and every graph is captured through the one capture
path, :func:`tpudl_torch.cuda_ops.capture_graph` (the executor's fused
dispatch, the program store, the serve engine's programs, the generate
graphs). The runtime twin of the static capture-boundary analyzer
(:mod:`tpudl_torch.analysis.traceguard`): the analyzer predicts capture
churn from the source (a fresh closure handed to the store or to a
capture each call); this module measures it.

``TPUDL_TRACECK=1`` arms the sentinel (``tpudl_torch/__init__`` installs
it before any module captures). :func:`install` replaces
``cuda_ops.capture_graph`` with a counting shim: each capture bumps a
counter keyed by the captured function's identity, its code object's
``file:line:qualname`` (the function a capture runs names what it wraps
through ``__wrapped__``: the executor's fused graph names the per-batch
function, a serve program its step). Identity is the code, not the
object, so a fresh closure built per call collapses onto one identity
and its captures pile up.

Findings:

- every capture bumps ``traceck.traces``; a second-or-later capture of
  one identity bumps ``traceck.retraces``;
- an identity captured **more than** ``TPUDL_TRACECK_STORM`` times
  (default 3) is a **recompile storm**: one finding per identity into
  the flight error ring (kind ``traceck.recompile_storm``) and
  ``traceck.storms``. ``python -m tpudl_torch.obs doctor`` classifies a
  dump carrying this evidence as ``recompile_storm``. Legitimate ladders
  capture one identity several times (a fused graph a bucket, a
  generate graph a prompt rung) and can cross the threshold as tpudl's
  bucket ladders do under jit.

Unarmed (the default) no module imports this one and ``capture_graph``
is untouched. Stdlib-only at import (``cuda_ops`` and the obs reporting
surface load inside :func:`install` and the finding path).
"""

from __future__ import annotations

import functools
import os

from tpudl_torch.testing.tsan import named_lock

__all__ = ["ENABLED", "DEFAULT_STORM", "arm", "disarm", "enabled",
           "install", "uninstall", "installed", "counts", "findings",
           "reset", "storm_threshold"]

#: armed at import when TPUDL_TRACECK=1 (tpudl_torch/__init__ then
#: installs); :func:`arm`/:func:`disarm` flip it in-process for tests.
ENABLED = os.environ.get("TPUDL_TRACECK", "0") == "1"

DEFAULT_STORM = 3

_LOCK = named_lock("testing.traceck")
_COUNTS: dict[str, int] = {}
_FINDINGS: list[dict] = []
_REAL_CAPTURE = None


def enabled() -> bool:
    """Is the sentinel armed right now?"""
    return ENABLED


# copied from tpudl/testing/traceck.py:storm_threshold
def storm_threshold() -> int:
    """Traces of one identity beyond which the storm finding files."""
    try:
        v = int(os.environ.get("TPUDL_TRACECK_STORM", "") or
                DEFAULT_STORM)
    except ValueError:
        return DEFAULT_STORM
    return max(1, v)


def _identity(fun) -> str:
    """A captured function's identity by CODE LOCATION, not object: what
    it wraps first (``__wrapped__``, ``functools.partial``'s ``func``),
    then its code's ``file:line:qualname``. Per-call closures share one
    identity, so their captures pile up visibly."""
    seen = set()
    while id(fun) not in seen:
        seen.add(id(fun))
        inner = getattr(fun, "__wrapped__", None) or \
            getattr(fun, "func", None)
        if inner is not None and inner is not fun:
            fun = inner
            continue
        code = getattr(fun, "__code__", None)
        if code is not None:
            qual = getattr(fun, "__qualname__",
                           getattr(fun, "__name__", "<fn>"))
            return f"{code.co_filename}:{code.co_firstlineno}:{qual}"
        call = getattr(type(fun), "__call__", None)
        code = getattr(call, "__code__", None)
        if code is not None:      # a callable object: its class's call
            return (f"{code.co_filename}:{code.co_firstlineno}:"
                    f"{type(fun).__qualname__}")
        break
    t = type(fun)
    return f"<{t.__module__}.{t.__qualname__}> " \
           f"{getattr(fun, '__name__', repr(type(fun)))}"


def _note_trace(ident: str):
    fire_retrace = False
    storm_count = None
    with _LOCK:
        n = _COUNTS.get(ident, 0) + 1
        _COUNTS[ident] = n
        fire_retrace = n >= 2
        if n == storm_threshold() + 1:
            storm_count = n
            entry = {"kind": "recompile_storm", "fn": ident,
                     "traces": n, "threshold": storm_threshold()}
            _FINDINGS.append(entry)
            del _FINDINGS[:-256]   # bounded even under a churn loop
    # metrics + flight hop AFTER release: the breadcrumb channel takes
    # its own (higher-ranked) locks, and the sentinel must never hold
    # its lock across them (lock-held-blocking)
    try:
        from tpudl_torch.obs import metrics as _m

        _m.counter("traceck.traces").inc()
        if fire_retrace:
            _m.counter("traceck.retraces").inc()
        if storm_count is not None:
            _m.counter("traceck.storms").inc()
            from tpudl_torch.obs import flight as _f

            _f.record_error(
                "traceck.recompile_storm",
                f"recompile storm: {ident} captured {storm_count} times "
                f"(> TPUDL_TRACECK_STORM={storm_threshold()}) — each "
                f"capture records a new CUDA graph and its memory pool; "
                f"check for a fresh closure handed to the program store "
                f"or to a capture per call (the static jit-cache-churn "
                f"rule names the site)", fn=ident, traces=storm_count)
    # tpudl: ignore[swallowed-except] — the sentinel's breadcrumb
    # channel is best-effort: obs may be unimportable in a minimal
    # subprocess, and counts()/findings() still carry the evidence
    except Exception:
        pass


def install():
    """Replace ``cuda_ops.capture_graph`` with the counting shim
    (idempotent). Called by ``tpudl_torch/__init__`` when
    ``TPUDL_TRACECK=1``. The shim wraps whatever ``capture_graph`` is at
    install time, so a test can put a stand-in there first."""
    global _REAL_CAPTURE
    from tpudl_torch import cuda_ops

    if getattr(cuda_ops.capture_graph, "_tpudl_traceck", False):
        return
    real = cuda_ops.capture_graph
    _REAL_CAPTURE = real

    @functools.wraps(real)
    def traceck_capture(run, *args, **kwargs):
        if ENABLED:
            _note_trace(_identity(run))
        # the CLOSED-OVER real capture, never the module global: a
        # module that bound it while armed keeps a working capture
        # after uninstall()
        return real(run, *args, **kwargs)

    traceck_capture._tpudl_traceck = True
    cuda_ops.capture_graph = traceck_capture


def installed() -> bool:
    from tpudl_torch import cuda_ops

    return bool(getattr(cuda_ops.capture_graph, "_tpudl_traceck", False))


def uninstall():
    """Restore the real ``capture_graph`` (tests)."""
    global _REAL_CAPTURE
    if _REAL_CAPTURE is None:
        return
    from tpudl_torch import cuda_ops

    if getattr(cuda_ops.capture_graph, "_tpudl_traceck", False):
        cuda_ops.capture_graph = _REAL_CAPTURE
    _REAL_CAPTURE = None


def arm():
    """Arm in-process AND install the shim (tests; production arms via
    TPUDL_TRACECK=1 at import)."""
    global ENABLED
    ENABLED = True
    install()


def disarm():
    """Stop counting (the shim stays installed but re-checks ENABLED)."""
    global ENABLED
    ENABLED = False


# copied from tpudl/testing/traceck.py:reset
def reset():
    """Drop every count/finding (tests)."""
    with _LOCK:
        _COUNTS.clear()
        _FINDINGS.clear()


# copied from tpudl/testing/traceck.py:counts
def counts() -> dict[str, int]:
    """Per-identity trace counts observed so far."""
    with _LOCK:
        return dict(_COUNTS)


# copied from tpudl/testing/traceck.py:findings
def findings() -> list[dict]:
    """Storm findings filed so far (one per storming identity)."""
    with _LOCK:
        return list(_FINDINGS)


if ENABLED:
    # armed via env: install as soon as anything imports the sentinel
    # (tpudl_torch/__init__ does, exactly once, before any capture)
    install()
