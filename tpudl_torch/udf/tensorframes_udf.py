"""makeGraphUDF — register an ingested graph as a SQL UDF.

Port of ``tpudl/udf/tensorframes_udf.py``. The graph is a
:class:`~tpudl_torch.ingest.TFInputGraph` (any route, frozen or
trainable) or a :class:`~tpudl_torch.ingest.GraphFunction`; the UDF runs
it as one batched call a block through ``Frame.map_batches`` on
``device`` (default ``"cuda"``), in f32
(:func:`~tpudl_torch.ml.tf_tensor.graph_batch_fn`), with the executor
knobs ``prefetch_depth``, ``prepare_workers``, ``fuse_steps`` and
``dispatch_depth`` and the data layer's ``wire_codec``, ``cache_dir`` and
``device_cache``, and files it with :mod:`tpudl_torch.udf.registry`:

    gin = TFInputGraph.fromKeras("model.keras")
    makeGraphUDF(gin, "my_udf")
    sql("SELECT my_udf(x) AS y FROM t", {"t": frame})

Each call counts ``udf.<name>.calls`` and ``.rows`` and times
``udf.<name>.seconds``, under a ``udf.<name>`` watchdog heartbeat and
host span (:func:`~tpudl_torch.udf.registry.metered`).
``mesh`` (a local :class:`~tpudl_torch.mesh.Mesh`) runs each block over
the mesh's cards, one per-batch function a card. ``blocked`` is
accepted and ignored, as in tpudl: one call a block is the only
execution model. SQL's ``fn(col)`` grammar binds one input; a graph with
several feeds registers all the same and runs as ``udf(frame)`` with
every mapped column present, as in tpudl.
"""

from __future__ import annotations

import torch

from tpudl_torch.udf.registry import UDF, metered, register_udf

__all__ = ["makeGraphUDF"]

def makeGraphUDF(graph, udf_name: str, fetches=None,
                 feeds_to_fields_map: dict[str, str] | None = None,
                 blocked: bool = True, register: bool = True, *,
                 batch_size: int = 256, device="cuda", mesh=None,
                 prefetch_depth: int | None = None,
                 prepare_workers: int | None = None,
                 fuse_steps: int | None = None,
                 dispatch_depth: int | None = None,
                 wire_codec=None,
                 cache_dir: str | None = None,
                 device_cache: bool | None = None) -> UDF:
    """Register ``graph`` as a SQL UDF named ``udf_name``.

    ``fetches`` restricts the graph's outputs (tensor names, a sequence);
    the first fetch is the UDF's output column value.
    ``feeds_to_fields_map`` maps graph input name → frame column name
    (default: the input's own op name). ``register=False`` builds and
    returns the UDF without filing it."""
    from tpudl_torch.ingest.builder import GraphFunction
    from tpudl_torch.ingest.input import TFInputGraph
    from tpudl_torch.ml.tf_tensor import function_batch_fn, graph_batch_fn

    if fetches is not None and isinstance(fetches, str):
        # a bare string would be list()-split into characters
        raise TypeError(
            f"fetches must be a sequence of tensor names, got the "
            f"string {fetches!r} — wrap it: fetches=[{fetches!r}]")
    if isinstance(graph, TFInputGraph):
        def build(dev):
            return graph_batch_fn(graph, dev,
                                  fetches=list(fetches) if fetches else None)

        if mesh is None:
            fn = build(device)
        else:
            from tpudl_torch.mesh import PerDevice

            fn = PerDevice({d: build(d) for d in mesh.distinct_devices()})
    elif isinstance(graph, GraphFunction):
        if fetches is not None:
            raise ValueError(
                "fetches selection applies to TFInputGraph; a "
                "GraphFunction already fixes its outputs")
        fn = function_batch_fn(graph.fn)
    else:
        raise TypeError(
            f"graph must be TFInputGraph or GraphFunction, got "
            f"{type(graph).__name__}")
    input_names = graph.input_names

    # copied from tpudl/udf/tensorframes_udf.py:makeGraphUDF._field
    def _field(name: str) -> str:
        op = name.split(":")[0]
        if feeds_to_fields_map:
            return feeds_to_fields_map.get(name,
                                           feeds_to_fields_map.get(op, op))
        return op

    in_cols = [_field(n) for n in input_names]
    out_col = f"{udf_name}_out"

    @torch.inference_mode()
    def run(frame):
        return frame.map_batches(
            fn, in_cols, [out_col], batch_size=batch_size, device=device,
            mesh=mesh, prefetch_depth=prefetch_depth, prepare_workers=prepare_workers,
            fuse_steps=fuse_steps, dispatch_depth=dispatch_depth,
            wire_codec=wire_codec, cache_dir=cache_dir,
            device_cache=device_cache)

    frame_fn = metered(udf_name, run, batch_size=batch_size)

    if register:
        return register_udf(udf_name, frame_fn, in_cols[0], out_col)
    return UDF(str(udf_name), frame_fn, in_cols[0], out_col)
