"""Model ingestion without TensorFlow or keras: ``.keras`` files read and
written (:mod:`~tpudl_torch.ingest.kerasfile` over the HDF5 subset of
:mod:`~tpudl_torch.ingest.hdf5`), their layer graphs evaluated in torch
(:mod:`~tpudl_torch.ingest.keras_graph`), and ``TFInputGraph``'s Keras
routes (:mod:`~tpudl_torch.ingest.input`). Port of ``tpudl/ingest``."""

from tpudl_torch.ingest.input import TFInputGraph
from tpudl_torch.ingest.keras_graph import build_torch_fn
from tpudl_torch.ingest.kerasfile import load_keras_file, save_keras_file

__all__ = ["TFInputGraph", "build_torch_fn", "load_keras_file",
           "save_keras_file"]
