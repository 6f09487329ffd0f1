"""``TFInputGraph``: an ingested model and its input and output names.

Port of ``tpudl/ingest/input.py``'s Keras routes. tpudl traces a Keras
model into a TF concrete function and evaluates its GraphDef in jax; the
port reads the ``.keras`` or legacy ``.h5`` model file itself
(:mod:`~tpudl_torch.ingest.kerasfile`) and evaluates the layer graph of
its config in torch (:mod:`~tpudl_torch.ingest.keras_graph`).

- ``fromKeras(model_file)``: inference; ``make_fn()`` is ``fn(x)`` with
  the weights frozen in (moved to ``x``'s device on first use there).
- ``fromKerasTrainable(model_file)``: ``params`` is ``{variable path:
  ndarray}`` in Keras's layout, keyed as tpudl's ``gin.params`` keys the
  same file (``conv2d/kernel``, ``batch_normalization/moving_mean``, ...;
  a legacy ``.h5`` file's Sequential layers under the model's name,
  ``layout`` ``"h5"``; in ``model.weights`` order), and ``make_fn()`` is
  ``fn(params, x)``
  over torch tensors, differentiable in every param, BN's moving
  statistics included, as tpudl's is.

``input_names`` and ``output_names`` are the Keras names of the input and
output layers as tensor names (``input_layer:0``, ``dense_2:0``), and
``input_dtypes`` the torch dtype of each input (its ``InputLayer``'s:
``int32`` ids for an ``Embedding``, float32 images); a model
may have several outputs (``fetches`` picks among them), not several
inputs. A live keras model object is refused: save it to
``.keras`` (or ``.h5``) and pass the path.

The GraphDef, SavedModel and checkpoint routes (tpudl's signatures)
read TF's protos and tensor bundles without TensorFlow
(:mod:`~tpudl_torch.ingest.protowire`,
:mod:`~tpudl_torch.ingest.tensor_bundle`), freeze the variables the
fetches reach (:mod:`~tpudl_torch.ingest.savedmodel`) and evaluate the
graph in torch (:mod:`~tpudl_torch.ingest.graphdef`):

- ``fromGraphDef(graph_def, feeds, fetches)``: a frozen GraphDef as bytes
  or as an object with ``SerializeToString()`` (a TF proto, never
  imported here);
- ``fromGraph(graph, sess, feeds, fetches)``: a live TF1 graph; its
  ``as_graph_def(add_shapes=True)`` and its variables' values through
  ``sess.run`` on the caller's objects;
- ``fromSavedModel(dir, tag_set, feeds, fetches)``,
  ``fromSavedModelWithSignature(dir, tag_set, key)``;
- ``fromCheckpoint(dir, feeds, fetches)``,
  ``fromCheckpointWithSignature(dir, key)``: a Saver checkpoint (the
  ``checkpoint`` state file, ``<prefix>.meta``, the bundle).

The tensor names are tpudl's on the same file. A graph the main
MetaGraph can freeze (every variable the fetches reach restored by name)
keeps the main graph's names, as tpudl's v1 route does: a Keras
``model.export`` signature reads ``serving_default_keras_tensor:0`` →
``StatefulPartitionedCall_1:0``. Otherwise a TF2 signature is its
function's graph, as tpudl's v2 route names it: feeds are the function's
argument names (``x:0``) and fetches ``Identity:0``, ``Identity_1:0``,
.... ``fromSavedModel`` takes either set where tpudl does. A proto graph
is inference only (``trainable`` is False); ``make_fn(feeds, fetches)``
is ``fn(*feeds)`` on the feeds' device.
"""

from __future__ import annotations

import logging
import os

import torch

from tpudl_torch.ingest import graphdef as gd
from tpudl_torch.ingest import protowire as pw
from tpudl_torch.ingest import savedmodel as sm
from tpudl_torch.ingest.keras_graph import (build_torch_fn, graph_steps,
                                            input_dtype)
from tpudl_torch.ingest.kerasfile import (bf16_variables, file_layout,
                                          load_keras_file)
from tpudl_torch.ingest.tensor_bundle import BundleReader, latest_checkpoint
from tpudl_torch.testing import tsan as _tsan

__all__ = ["TFInputGraph", "keras_model_path"]


def keras_model_path(model_file) -> str:
    """A model file argument as a path; a live keras model is refused."""
    if isinstance(model_file, (str, os.PathLike)):
        return os.fspath(model_file)
    raise TypeError(
        f"expected a path to a .keras or .h5 model file, got "
        f"{type(model_file).__name__}"
        "; tpudl_torch does not import keras: save the model with "
        "model.save('model.keras') and pass the path")


class TFInputGraph:
    def __init__(self, config: dict, weights: dict, *, trainable: bool,
                 layout: str = "keras"):
        # refuses what it cannot run
        _steps, src, outs = graph_steps(config, layout)
        self.config = config
        self.layout = layout
        self.input_names = [f"{src}:0"]
        self.input_dtypes = [input_dtype(config)]
        self.output_names = [f"{o}:0" for o in outs]
        self.params = dict(weights) if trainable else None
        self._weights = weights
        self._bf16 = bf16_variables(config, layout)
        self._frozen: dict = {}
        self._lock = _tsan.named_lock("ingest.input.graph")
        self.graph_def = None
        self.input_tensor_name_from_signature = None
        self.output_tensor_name_from_signature = None

    @classmethod
    def _from_proto(cls, graph_def, input_names, output_names,
                    input_sig=None, output_sig=None):
        """A frozen proto graph, its feeds and fetches validated as tpudl
        validates them."""
        self = cls.__new__(cls)
        self.graph_def = graph_def
        nodes = gd.node_op_map(graph_def)
        self.input_names = [gd.validated_input(graph_def, n, nodes)
                            for n in input_names]
        self.output_names = [gd.validated_output(graph_def, n, nodes)
                             for n in output_names]
        self.input_tensor_name_from_signature = input_sig
        self.output_tensor_name_from_signature = output_sig
        self.config = None
        self.params = None
        self._fns: dict = {}
        self._lock = _tsan.named_lock("ingest.input.graph")
        return self

    @property
    def trainable(self) -> bool:
        return self.params is not None

    def __repr__(self):
        return (f"TFInputGraph(inputs={self.input_names}, "
                f"outputs={self.output_names}, trainable={self.trainable})")

    def _check_names(self, feeds, fetches):
        if self.graph_def is not None:
            return
        bad = ((feeds is not None and list(feeds) != self.input_names) or
               (fetches is not None and not set(fetches) <= set(
                   self.output_names)))
        if bad:
            raise NotImplementedError(
                f"feeds/fetches {feeds}/{fetches}: a Keras graph is run "
                f"from its input {self.input_names} to its outputs "
                f"{self.output_names} only")

    def frozen_params(self, device) -> dict:
        """The weights as torch tensors on ``device``, made once; a
        ``bfloat16`` layer's variables in bfloat16, as keras keeps them."""
        device = torch.device(device)
        with self._lock:
            if device not in self._frozen:
                self._frozen[device] = {
                    k: torch.as_tensor(v).to(device, torch.bfloat16
                                             if k in self._bf16 else None)
                    for k, v in self._weights.items()}
            return self._frozen[device]

    def make_fn(self, feeds=None, fetches=None):
        """``fn(params, x)`` for a trainable graph, else ``fn(x)``; it
        returns the ``fetches`` (default: every output), one tensor for
        one, else a tuple."""
        self._check_names(feeds, fetches)
        if self.graph_def is not None:
            key = (tuple(feeds or self.input_names),
                   tuple(fetches or self.output_names))
            with self._lock:
                if key not in self._fns:     # constants stay on the device
                    self._fns[key] = gd.build_torch_fn(self.graph_def, *key)
                return self._fns[key]
        fn = build_torch_fn(self.config, None if fetches is None else
                            [f.split(":")[0] for f in fetches], self.layout)
        if self.trainable:
            return fn
        return lambda x: fn(self.frozen_params(x.device), x)

    # -- the Keras routes ------------------------------------------------
    @classmethod
    def _from_file(cls, model_file, trainable):
        path = keras_model_path(model_file)
        config, weights = load_keras_file(path)
        return cls(config, weights, trainable=trainable,
                   layout=file_layout(path))

    @classmethod
    def fromKeras(cls, model_file):
        """A ``.keras`` or ``.h5`` model file → a frozen inference graph."""
        return cls._from_file(model_file, trainable=False)

    @classmethod
    def fromKerasTrainable(cls, model_file):
        """A ``.keras`` or ``.h5`` model file → a trainable graph:
        ``params`` and ``make_fn()`` = ``fn(params, x)``."""
        return cls._from_file(model_file, trainable=True)

    # -- the GraphDef, SavedModel and checkpoint routes -------------------
    @classmethod
    def fromGraph(cls, graph, sess, feed_names, fetch_names):
        """A live TF1 graph and session: the graph's GraphDef, its
        variables' values read through ``sess.run``."""
        gdef = pw.parse("GraphDef", graph.as_graph_def(
            add_shapes=True).SerializeToString())
        reads = {n.input[0]: n.name for n in gdef.node
                 if n.op == "ReadVariableOp" and n.input}

        def values(node):
            name = node.name if node.op != "VarHandleOp" else reads.get(
                node.name)
            if name is None:
                raise sm.FreezeError(
                    f"resource variable {node.name!r} has no ReadVariableOp "
                    "to read its value through")
            value = sess.run(gd.tensor_name(name))
            return pw.new("NodeDef", name=node.name, op="Const", attr={
                "value": pw.new("AttrValue", tensor=pw.tensor_proto(value))})

        return cls._from_proto(sm.freeze(gdef, fetch_names, values),
                               feed_names, fetch_names)

    @classmethod
    def fromGraphDef(cls, graph_def, feed_names, fetch_names):
        """An already-frozen GraphDef: bytes, a parsed graph, or a TF proto
        (read through its ``SerializeToString()``)."""
        if isinstance(graph_def, (bytes, bytearray, memoryview)):
            graph_def = pw.parse("GraphDef", graph_def)
        elif not isinstance(graph_def, pw.Message):
            graph_def = pw.parse("GraphDef", graph_def.SerializeToString())
        return cls._from_proto(graph_def, feed_names, fetch_names)

    @classmethod
    def fromSavedModel(cls, saved_model_dir, tag_set, feed_names,
                       fetch_names):
        """A SavedModel with explicit feeds and fetches: the main graph
        frozen to the fetches, else (a TF2 export whose variables the main
        graph cannot restore, or fetches it lacks) the
        ``serving_default`` signature's function graph."""
        meta, bundle = _saved_model(saved_model_dir, tag_set)
        try:
            gdef = _freeze_v1(meta, bundle, fetch_names)
        except (sm.FreezeError, KeyError) as v1_err:
            _log_v1_fallback(saved_model_dir, v1_err)
            try:
                gdef, _in, _out = sm.signature_function_graph(
                    meta, "serving_default", bundle)
            except (sm.FreezeError, KeyError):
                raise v1_err from None
        return cls._from_proto(gdef, feed_names, fetch_names)

    @classmethod
    def fromSavedModelWithSignature(cls, saved_model_dir, tag_set,
                                    signature_def_key):
        """A SavedModel; feeds and fetches from its SignatureDef."""
        meta, bundle = _saved_model(saved_model_dir, tag_set)
        try:
            in_sig, out_sig = sm.signature_maps(meta, signature_def_key)
            fetch_names = list(out_sig.values())
            gdef = _freeze_v1(meta, bundle, fetch_names)
        except (sm.FreezeError, KeyError) as v1_err:
            _log_v1_fallback(saved_model_dir, v1_err)
            gdef, in_sig, out_sig = sm.signature_function_graph(
                meta, signature_def_key, bundle)
            fetch_names = list(out_sig.values())
        return cls._from_proto(gdef, list(in_sig.values()), fetch_names,
                               input_sig=in_sig, output_sig=out_sig)

    @classmethod
    def fromCheckpoint(cls, checkpoint_dir, feed_names, fetch_names):
        """A TF1 Saver checkpoint directory."""
        meta, bundle = _checkpoint(checkpoint_dir)
        return cls._from_proto(_freeze_v1(meta, bundle, fetch_names),
                               feed_names, fetch_names)

    @classmethod
    def fromCheckpointWithSignature(cls, checkpoint_dir, signature_def_key):
        """A checkpoint; feeds and fetches from its MetaGraph's
        SignatureDef."""
        meta, bundle = _checkpoint(checkpoint_dir)
        in_sig, out_sig = sm.signature_maps(meta, signature_def_key)
        fetch_names = list(out_sig.values())
        return cls._from_proto(_freeze_v1(meta, bundle, fetch_names),
                               list(in_sig.values()), fetch_names,
                               input_sig=in_sig, output_sig=out_sig)


def _saved_model(saved_model_dir, tag_set):
    meta = sm.meta_graph(sm.read_saved_model(saved_model_dir), tag_set)
    prefix = os.path.join(saved_model_dir, "variables", "variables")
    bundle = BundleReader(prefix) if os.path.exists(prefix + ".index") \
        else None
    return meta, bundle


def _checkpoint(checkpoint_dir):
    ckpt = latest_checkpoint(checkpoint_dir)
    if ckpt is None:
        raise ValueError(f"no checkpoint found under {checkpoint_dir!r}")
    return sm.read_meta_graph(ckpt + ".meta"), BundleReader(ckpt)


def _freeze_v1(meta, bundle, fetch_names):
    """The main graph frozen to ``fetch_names`` (tpudl's v1 route)."""
    graph = meta.graph_def
    if bundle is None:
        def values(node):
            raise sm.FreezeError(f"variable {node.name!r}: the SavedModel "
                                 "has no variables/")
    else:
        values = sm.bundle_values(bundle,
                                  sm.restore_keys(graph, meta.saver_def))
    return sm.freeze(graph, fetch_names, values)


def _log_v1_fallback(saved_model_dir, err):
    """INFO, as tpudl logs it: every TF2 object-graph export takes the
    signature-function route."""
    logging.getLogger("tpudl_torch.ingest").info(
        "main-graph freeze of %r failed (%s: %s); using the signature's "
        "function graph", saved_model_dir, type(err).__name__, err)
