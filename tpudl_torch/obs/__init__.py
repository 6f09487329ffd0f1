"""Observability for the port: the metrics registry (``metrics``)."""

from tpudl_torch.obs.metrics import counter, gauge, histogram, snapshot

__all__ = ["counter", "gauge", "histogram", "snapshot"]
