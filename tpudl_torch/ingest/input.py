"""``TFInputGraph``: an ingested model and its input and output names.

Port of ``tpudl/ingest/input.py``'s Keras routes. tpudl traces a Keras
model into a TF concrete function and evaluates its GraphDef in jax; the
port reads the ``.keras`` file itself (:mod:`~tpudl_torch.ingest.kerasfile`)
and evaluates the layer graph of its ``config.json`` in torch
(:mod:`~tpudl_torch.ingest.keras_graph`).

- ``fromKeras(model_file)``: inference; ``make_fn()`` is ``fn(x)`` with
  the weights frozen in (moved to ``x``'s device on first use there).
- ``fromKerasTrainable(model_file)``: ``params`` is ``{variable path:
  ndarray}`` in Keras's layout, keyed as tpudl's ``gin.params`` keys the
  same file (``conv2d/kernel``, ``batch_normalization/moving_mean``, ...;
  in ``model.weights`` order), and ``make_fn()`` is ``fn(params, x)``
  over torch tensors, differentiable in every param, BN's moving
  statistics included, as tpudl's is.

``input_names`` and ``output_names`` are the Keras names of the input and
output layers as tensor names (``input_layer:0``, ``dense_2:0``). A live keras model object is refused: save it to
``.keras`` and pass the path. The routes that need TF protos
(``fromGraph``, ``fromGraphDef``, ``fromSavedModel*``,
``fromCheckpoint*``) are refused by name (ROADMAP Queue 1, 'The rest of
the sparkdl surface', ingest).
"""

from __future__ import annotations

import os
import threading

import torch

from tpudl_torch.ingest.keras_graph import build_torch_fn, graph_steps
from tpudl_torch.ingest.kerasfile import load_keras_file

__all__ = ["TFInputGraph", "keras_model_path"]


def keras_model_path(model_file) -> str:
    """A model file argument as a path; a live keras model is refused."""
    if isinstance(model_file, (str, os.PathLike)):
        return os.fspath(model_file)
    raise TypeError(
        f"expected a path to a .keras file, got {type(model_file).__name__}"
        "; tpudl_torch does not import keras: save the model with "
        "model.save('model.keras') and pass the path")


def _proto_route(name: str):
    raise NotImplementedError(
        f"TFInputGraph.{name} needs TensorFlow protos and is not ported to "
        "tpudl_torch yet (ROADMAP Queue 1, 'The rest of the sparkdl "
        "surface', ingest); save the model as .keras and use fromKeras")


class TFInputGraph:
    def __init__(self, config: dict, weights: dict, *, trainable: bool):
        _steps, src, out = graph_steps(config)  # refuses what it cannot run
        self.config = config
        self.input_names = [f"{src}:0"]
        self.output_names = [f"{out}:0"]
        self.params = dict(weights) if trainable else None
        self._weights = weights
        self._frozen: dict = {}
        self._lock = threading.Lock()

    @property
    def trainable(self) -> bool:
        return self.params is not None

    def __repr__(self):
        return (f"TFInputGraph(inputs={self.input_names}, "
                f"outputs={self.output_names}, trainable={self.trainable})")

    def _check_names(self, feeds, fetches):
        for given, have in ((feeds, self.input_names),
                            (fetches, self.output_names)):
            if given is not None and list(given) != have:
                raise NotImplementedError(
                    f"feeds/fetches {list(given)}: a Keras graph is run from "
                    f"its input {self.input_names} to its output "
                    f"{self.output_names} only")

    def frozen_params(self, device) -> dict:
        """The weights as torch tensors on ``device``, made once."""
        device = torch.device(device)
        with self._lock:
            if device not in self._frozen:
                self._frozen[device] = {
                    k: torch.as_tensor(v).to(device)
                    for k, v in self._weights.items()}
            return self._frozen[device]

    def make_fn(self, feeds=None, fetches=None):
        """``fn(params, x)`` for a trainable graph, else ``fn(x)``."""
        self._check_names(feeds, fetches)
        fn = build_torch_fn(self.config)
        if self.trainable:
            return fn
        return lambda x: fn(self.frozen_params(x.device), x)

    # -- the Keras routes ------------------------------------------------
    @classmethod
    def fromKeras(cls, model_file):
        """A ``.keras`` file → a frozen inference graph."""
        config, weights = load_keras_file(keras_model_path(model_file))
        return cls(config, weights, trainable=False)

    @classmethod
    def fromKerasTrainable(cls, model_file):
        """A ``.keras`` file → a trainable graph: ``params`` and
        ``make_fn()`` = ``fn(params, x)``."""
        config, weights = load_keras_file(keras_model_path(model_file))
        return cls(config, weights, trainable=True)

    # -- routes that need TF protos --------------------------------------
    @classmethod
    def fromGraph(cls, *args, **kwargs):
        _proto_route("fromGraph")

    @classmethod
    def fromGraphDef(cls, *args, **kwargs):
        _proto_route("fromGraphDef")

    @classmethod
    def fromSavedModel(cls, *args, **kwargs):
        _proto_route("fromSavedModel")

    @classmethod
    def fromSavedModelWithSignature(cls, *args, **kwargs):
        _proto_route("fromSavedModelWithSignature")

    @classmethod
    def fromCheckpoint(cls, *args, **kwargs):
        _proto_route("fromCheckpoint")

    @classmethod
    def fromCheckpointWithSignature(cls, *args, **kwargs):
        _proto_route("fromCheckpointWithSignature")
