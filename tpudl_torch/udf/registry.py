"""Model-as-UDF registry.

Copied from ``tpudl/udf/registry.py``: a UDF is a named callable ``Frame
→ Frame`` (one batched call a block inside) plus the input and output
column names that :func:`tpudl_torch.frame.sql` binds to. The port keeps
its own registry; it never shares tpudl's. :func:`metered` is the
per-UDF instrumentation the port's UDFs share, as tpudl's UDFs each
carry it: the counters and latency histogram, a watchdog heartbeat and a
host span named after the UDF.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from tpudl_torch.obs import metrics as _obs_metrics
from tpudl_torch.obs import tracer as _obs_tracer
from tpudl_torch.obs import watchdog as _obs_watchdog

__all__ = ["UDF", "register_udf", "get_udf", "list_udfs", "unregister_udf",
           "metered"]


# copied from tpudl/udf/registry.py:UDF
@dataclasses.dataclass(frozen=True)
class UDF:
    name: str
    fn: Callable  # Frame -> Frame, reading input_col, appending output_col
    input_col: str
    output_col: str

    def __call__(self, frame):
        return self.fn(frame)


_REGISTRY: dict[str, UDF] = {}


# copied from tpudl/udf/registry.py:register_udf
def register_udf(name: str, fn: Callable, input_col: str, output_col: str) -> UDF:
    udf = UDF(str(name), fn, input_col, output_col)
    _REGISTRY[udf.name] = udf
    return udf


# copied from tpudl/udf/registry.py:get_udf
def get_udf(name: str) -> UDF:
    if name not in _REGISTRY:
        raise KeyError(f"no UDF registered as {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_udfs() -> list[str]:
    return sorted(_REGISTRY)


def unregister_udf(name: str) -> None:
    _REGISTRY.pop(name, None)


def metered(udf_name: str, run: Callable, **info) -> Callable:
    """``run`` (``Frame → Frame``) counted as tpudl counts a UDF call:
    ``udf.<name>.seconds`` (histogram), ``.calls`` and ``.rows``; the call
    holds a ``udf.<name>`` watchdog heartbeat (a wedged UDF is a stall
    named after it; ``info`` rides on it) and is a ``udf.<name>`` host
    span."""
    def frame_fn(frame):
        with _obs_watchdog.heartbeat(f"udf.{udf_name}", rows=len(frame),
                                     **info), \
                _obs_metrics.timed(f"udf.{udf_name}.seconds"), \
                _obs_tracer.span(f"udf.{udf_name}", rows=len(frame)):
            out = run(frame)
        _obs_metrics.counter(f"udf.{udf_name}.calls").inc()
        _obs_metrics.counter(f"udf.{udf_name}.rows").inc(len(frame))
        return out

    return frame_fn
