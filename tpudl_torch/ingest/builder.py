"""Graph-function composition: ``GraphFunction`` and ``IsolatedSession``.

Port of ``tpudl/ingest/builder.py``. A :class:`GraphFunction` is a torch
callable with named inputs and outputs; ``fromList`` pipes a sequence of
them into one function (tpudl's composition, the reference's protobuf
splice). ``IsolatedSession`` is tpudl's compatibility shim: a torch
function holds no session state, so it only offers the reference's
``asGraphFunction``/``importGraphFunction`` verbs. ``fromKeras`` takes a
``.keras`` or ``.h5`` file (a live keras model is refused, as
``TFInputGraph.fromKeras`` refuses it).
"""

from __future__ import annotations

from typing import Callable, Sequence

from tpudl_torch.ingest.graphdef import tensor_name

__all__ = ["GraphFunction", "IsolatedSession"]


# copied from tpudl/ingest/builder.py:GraphFunction
class GraphFunction:
    """A torch callable with named inputs/outputs (the value object the
    reference serializes as (graph_def, inputs, outputs))."""

    def __init__(self, fn: Callable, input_names: Sequence[str] = ("input",),
                 output_names: Sequence[str] = ("output",)):
        if not callable(fn):
            raise TypeError(f"fn must be callable, got {type(fn).__name__}")
        self.fn = fn
        self.input_names = [tensor_name(n) for n in input_names]
        self.output_names = [tensor_name(n) for n in output_names]

    def __call__(self, *args):
        return self.fn(*args)

    def __repr__(self):
        return (f"GraphFunction({self.input_names} -> {self.output_names})")

    @classmethod
    def fromKeras(cls, model_file) -> "GraphFunction":
        """A ``.keras``/``.h5`` model file → a frozen GraphFunction."""
        from tpudl_torch.ingest.input import TFInputGraph

        return cls.fromTFInputGraph(TFInputGraph.fromKeras(model_file))

    @classmethod
    def fromTFInputGraph(cls, gin) -> "GraphFunction":
        fn = gin.make_fn()
        if gin.trainable:
            params = gin.params
            base = fn
            fn = lambda *xs: base(params, *xs)  # noqa: E731
        return cls(fn, gin.input_names, gin.output_names)

    @classmethod
    def fromList(cls, functions: Sequence[tuple[str, "GraphFunction"]]
                 ) -> "GraphFunction":
        """Splice [(scope, gfn), ...] into ONE GraphFunction piping each
        stage's outputs into the next stage's inputs. Arities must chain:
        stage k's output count == stage k+1's input count."""
        functions = list(functions)
        if not functions:
            raise ValueError("fromList of zero functions")
        for (sa, a), (sb, b) in zip(functions, functions[1:]):
            if len(a.output_names) != len(b.input_names):
                raise ValueError(
                    f"cannot pipe {sa!r} ({len(a.output_names)} outputs) "
                    f"into {sb!r} ({len(b.input_names)} inputs)")

        def piped(*args):
            out = args
            for _scope, g in functions:
                res = g(*out)
                out = res if isinstance(res, tuple) else (res,)
            return out if len(out) != 1 else out[0]

        first_scope, first = functions[0]
        last_scope, last = functions[-1]
        return cls(
            piped,
            [f"{first_scope}/{n}" if first_scope else n
             for n in first.input_names],
            [f"{last_scope}/{n}" if last_scope else n
             for n in last.output_names])


# copied from tpudl/ingest/builder.py:IsolatedSession
class IsolatedSession:
    """Compatibility shim: a torch function has no global graph, so
    'isolation' is the default; this context manager offers the
    reference's verbs:

        with IsolatedSession() as issn:
            gfn = issn.importGraphFunction(other_gfn)
            out_gfn = issn.asGraphFunction(my_callable)
    """

    def __init__(self, using_keras: bool = False):
        self.using_keras = using_keras  # accepted for parity; no-op

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def asGraphFunction(self, fn, input_names=("input",),
                        output_names=("output",)) -> GraphFunction:
        return GraphFunction(fn, input_names, output_names)

    def importGraphFunction(self, gfn: GraphFunction, prefix: str = ""
                            ) -> GraphFunction:
        if prefix:
            return GraphFunction(
                gfn.fn,
                [f"{prefix}/{n}" for n in gfn.input_names],
                [f"{prefix}/{n}" for n in gfn.output_names])
        return gfn
