"""Model ingestion without TensorFlow or keras: ``.keras`` files read and
written (:mod:`~tpudl_torch.ingest.kerasfile` over the HDF5 subset of
:mod:`~tpudl_torch.ingest.hdf5`), their layer graphs evaluated in torch
(:mod:`~tpudl_torch.ingest.keras_graph`); TF's GraphDef, SavedModel and
checkpoint files read from their protobuf wire format and tensor bundles
(:mod:`~tpudl_torch.ingest.protowire`,
:mod:`~tpudl_torch.ingest.tensor_bundle`,
:mod:`~tpudl_torch.ingest.savedmodel`) and evaluated in torch
(:mod:`~tpudl_torch.ingest.graphdef`); ``TFInputGraph``'s routes
(:mod:`~tpudl_torch.ingest.input`) and ``GraphFunction``
(:mod:`~tpudl_torch.ingest.builder`). Port of ``tpudl/ingest``."""

from tpudl_torch.ingest.builder import GraphFunction, IsolatedSession
from tpudl_torch.ingest.graphdef import UnsupportedOpError
from tpudl_torch.ingest.graphdef import build_torch_fn as build_graph_fn
from tpudl_torch.ingest.input import TFInputGraph
from tpudl_torch.ingest.keras_graph import build_torch_fn
from tpudl_torch.ingest.kerasfile import load_keras_file, save_keras_file

__all__ = ["TFInputGraph", "GraphFunction", "IsolatedSession",
           "UnsupportedOpError", "build_torch_fn", "build_graph_fn",
           "load_keras_file", "save_keras_file"]
