"""Observability for the port: the metrics registry (``metrics``) and the
executor's per-run pipeline reports (``pipeline``)."""

from tpudl_torch.obs.metrics import counter, gauge, histogram, snapshot
from tpudl_torch.obs.pipeline import (PipelineReport, get_pipeline_report,
                                      last_pipeline_report,
                                      pipeline_reports, set_last_pipeline)

__all__ = ["counter", "gauge", "histogram", "snapshot", "PipelineReport",
           "set_last_pipeline", "last_pipeline_report", "pipeline_reports",
           "get_pipeline_report"]
