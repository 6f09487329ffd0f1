"""tpudl_torch.serve — continuous-batching online inference.

Port of ``tpudl/serve``: an admission-controlled request queue with
per-request deadlines (:class:`RequestQueue`, :class:`ServeRequest`,
typed :class:`AdmissionError`/:class:`DeadlineExceeded`/:class:`Evicted`),
rung-bucketed dynamic batching for ragged featurize/UDF/embed payloads
(:class:`RungBatcher`), slot-based continuous batch decoding for
``TinyCausalLM`` on a fixed-geometry KV cache, one CUDA graph per
geometry on the card (:class:`SlotDecoder`), a multi-model registry that
captures every model's graphs at registration (:class:`ModelRegistry`),
the serve loop (:class:`Server`), request lifecycle traces
(:class:`ReqTrace`) and a closed-loop load generator
(:func:`run_closed_loop`). ``serve.*`` metrics publish through
``tpudl_torch.obs.metrics``.
"""

from tpudl_torch.serve.queue import (AdmissionError, DeadlineExceeded,
                                     Evicted, RequestQueue, ServeRequest)
from tpudl_torch.serve.reqtrace import ReqTrace
from tpudl_torch.serve.batching import RungBatcher
from tpudl_torch.serve.slots import SlotDecoder
from tpudl_torch.serve.registry import ModelRegistry
from tpudl_torch.serve.server import Server
from tpudl_torch.serve.loadgen import run_closed_loop

__all__ = ["AdmissionError", "DeadlineExceeded", "Evicted",
           "RequestQueue", "ServeRequest", "ReqTrace", "RungBatcher",
           "SlotDecoder", "ModelRegistry", "Server", "run_closed_loop"]
