"""SavedModels, Saver checkpoints and their variables, read without
TensorFlow; graphs frozen against their tensor bundles.

- :func:`read_saved_model` / :func:`meta_graph`: ``saved_model.pb`` and
  the MetaGraphDef of a tag set (a string ``"serve"``, comma-separated
  tags, or a list, as tpudl's ``_tags`` takes it).
- :func:`signature_maps`: a SignatureDef's {logical name → tensor name}
  maps, with tpudl's ``KeyError`` listing the available keys.
- :func:`restore_keys`: each variable's bundle key, from the graph's own
  restore subgraph: ``SaverDef.restore_op_name`` → ``RestoreV2``'s
  ``tensor_names`` constant → the assign op that takes ``RestoreV2:i``
  (``Assign`` of a ``VariableV2``, ``AssignVariableOp`` of a
  ``VarHandleOp``). A TF2 export holds the pattern inside
  ``__inference__traced_restore_*``, which the main graph calls with its
  ``VarHandleOp`` handles.
- :func:`freeze`: the subgraph the fetches reach, each variable a ``Const``
  with its value from the bundle (only the keys the fetches reach are
  read). This is tpudl's v1 route (``convert_variables_to_constants``):
  the main graph's names.
- :func:`signature_function_graph`: a TF2 signature as tpudl's v2 route
  (``convert_variables_to_constants_v2`` of the signature's concrete
  function) names it: the wrapper function's body as a graph, its
  argument names as placeholders, its resource arguments as constants,
  its outputs ``Identity:0``, ``Identity_1:0``, ...
"""

from __future__ import annotations

import os

from tpudl_torch.ingest import protowire as pw
from tpudl_torch.ingest.graphdef import (_CALL_OPS, function_graph, op_name,
                                         tensor_name)
from tpudl_torch.ingest.tensor_bundle import BundleReader

__all__ = ["read_saved_model", "meta_graph", "read_meta_graph",
           "signature_maps", "restore_keys", "freeze",
           "signature_function_graph", "FreezeError"]

VARIABLE_OPS = ("VariableV2", "Variable", "VarHandleOp")
_ASSIGN_OPS = ("Assign", "AssignVariableOp")


class FreezeError(ValueError):
    """The graph cannot be frozen as asked (a fetch it lacks, a variable
    with no value in the bundle)."""


def read_saved_model(saved_model_dir: str):
    path = os.path.join(saved_model_dir, "saved_model.pb")
    if not os.path.exists(path):
        if os.path.exists(os.path.join(saved_model_dir, "saved_model.pbtxt")):
            raise NotImplementedError(
                f"{saved_model_dir!r} holds a text-format saved_model.pbtxt;"
                " only the binary saved_model.pb is read")
        raise OSError(f"no SavedModel at {saved_model_dir!r} (no "
                      "saved_model.pb)")
    with open(path, "rb") as f:
        return pw.parse("SavedModel", f.read())


# copied from tpudl/ingest/input.py:_tags
def tags(tag_set):
    if isinstance(tag_set, str):
        return tag_set.split(",")
    return list(tag_set)


def meta_graph(saved_model, tag_set):
    """The MetaGraphDef whose tags are ``tag_set``."""
    want = set(tags(tag_set))
    found = [list(m.meta_info_def.tags) for m in saved_model.meta_graphs]
    for m, t in zip(saved_model.meta_graphs, found):
        if set(t) == want:
            return m
    raise RuntimeError(
        f"MetaGraphDef associated with tags {sorted(want)} could not be "
        f"found in SavedModel; available tag sets: {found}")


def read_meta_graph(path: str):
    with open(path, "rb") as f:
        data = f.read()
    try:
        return pw.parse("MetaGraphDef", data)
    except pw.ProtoError as e:
        raise ValueError(f"corrupt meta graph {path}") from e


# copied from tpudl/ingest/input.py:_signature_maps
def signature_maps(meta_graph, signature_def_key):
    sig = meta_graph.signature_def.get(signature_def_key)
    if sig is None:
        raise KeyError(
            f"SignatureDef {signature_def_key!r} not found; available: "
            f"{sorted(meta_graph.signature_def)}")
    in_sig = {k: v.name for k, v in sig.inputs.items()}
    out_sig = {k: v.name for k, v in sig.outputs.items()}
    return in_sig, out_sig


# -- variables -> bundle keys ----------------------------------------------------
def _restored_key(nodes: dict, tensor: str):
    """The bundle key whose restored value ``tensor`` is (through
    Identities), or None."""
    name = tensor
    node = nodes.get(op_name(name))
    while node is not None and node.op == "Identity" and node.input:
        name = node.input[0]
        node = nodes.get(op_name(name))
    if node is None or node.op not in ("RestoreV2", "Restore"):
        return None
    idx = int(tensor_name(name).split(":")[1])
    names_node = nodes.get(op_name(node.input[1]))
    if names_node is None or names_node.op != "Const":
        return None
    names = pw.make_ndarray(names_node.attr["value"].tensor).reshape(-1)
    v = names[idx]
    return v.decode("utf-8") if isinstance(v, bytes) else str(v)


def _assigned(nodes: dict, roots) -> dict:
    """{assigned input name → bundle key} over the assign ops upstream of
    ``roots`` (all of ``nodes`` when roots is None)."""
    if roots is None:
        names = list(nodes)
    else:
        names, seen, todo = [], set(), list(roots)
        while todo:
            n = todo.pop()
            if n in seen or n not in nodes:
                continue
            seen.add(n)
            names.append(n)
            todo.extend(op_name(i) for i in nodes[n].input)
    out = {}
    for n in names:
        node = nodes[n]
        if node.op in _ASSIGN_OPS and len(node.input) >= 2:
            key = _restored_key(nodes, node.input[1])
            if key is not None:
                out[op_name(node.input[0])] = key
    return out


def restore_keys(graph_def, saver_def=None, *, aliases: bool = False) -> dict:
    """{variable node name → bundle key} from the graph's restore
    subgraph (the whole graph when it names no restore op).

    ``aliases``: a handle that is not restored itself but initializes a
    restored variable (``AssignVariableOp(V, ReadVariableOp(H))``, as
    ``tf.saved_model.save`` writes for a signature over a Keras model)
    takes that variable's key."""
    nodes = {n.name: n for n in graph_def.node}
    library = {f.signature.name: f for f in graph_def.library.function}
    root = op_name(saver_def.restore_op_name) if (
        saver_def is not None and saver_def.restore_op_name) else None
    keys = _assigned(nodes, [root] if root in nodes else None)
    calls = [nodes[root]] if root in nodes and nodes[root].op in _CALL_OPS \
        else []
    for call in calls:
        fdef = library.get(call.attr["f"].func.name)
        if fdef is None:
            continue
        body, _rets = function_graph(fdef)
        args = [a.name for a in fdef.signature.input_arg]
        for arg, key in _assigned({n.name: n for n in body}, None).items():
            if arg in args:
                keys[op_name(call.input[args.index(arg)])] = key
    if aliases:
        for node in graph_def.node:
            if node.op != "AssignVariableOp" or node.input[0] not in keys:
                continue
            src = nodes.get(op_name(node.input[1]))
            if src is not None and src.op == "ReadVariableOp":
                keys.setdefault(op_name(src.input[0]), keys[node.input[0]])
    return keys


def _const_node(name: str, bundle: BundleReader, key: str):
    e = bundle.entries[key]
    tensor = pw.new("TensorProto", dtype=e.dtype, tensor_shape=e.shape,
                    tensor_content=bundle.raw(key))
    return pw.new("NodeDef", name=name, op="Const", attr={
        "dtype": pw.new("AttrValue", type=e.dtype),
        "value": pw.new("AttrValue", tensor=tensor)})


def _copy_node(node, inputs=None):
    return pw.new("NodeDef", name=node.name, op=node.op,
                  input=list(node.input if inputs is None else inputs),
                  attr=node.attr)


def freeze(graph_def, fetches, values):
    """The subgraph that ``fetches`` reach through data inputs, each
    variable in it a ``Const``. ``values(node)`` gives a variable node's
    Const (raising :class:`FreezeError` when it has none)."""
    nodes = {n.name: n for n in graph_def.node}
    keep, todo = set(), [op_name(f) for f in fetches]
    for f in todo:
        if f not in nodes:
            raise FreezeError(f"fetch {f!r} is not in the graph")
    while todo:
        n = todo.pop()
        if n in keep:
            continue
        keep.add(n)
        todo.extend(op_name(i) for i in nodes[n].input
                    if not i.startswith("^") and op_name(i) in nodes)
    out = []
    for node in graph_def.node:
        if node.name not in keep:
            continue
        if node.op in VARIABLE_OPS:
            out.append(values(node))
        else:
            out.append(_copy_node(node, [i for i in node.input
                                         if not i.startswith("^")]))
    return pw.new("GraphDef", node=out, library=graph_def.library)


def bundle_values(bundle: BundleReader, keys: dict):
    """``freeze``'s ``values`` over a bundle and :func:`restore_keys`."""
    def values(node):
        key = keys.get(node.name)
        if key is None or key not in bundle:
            raise FreezeError(
                f"variable {node.name!r} has no value in the bundle "
                f"{bundle.prefix!r} (no restore op assigns it)")
        return _const_node(node.name, bundle, key)
    return values


def signature_function_graph(meta, signature_def_key, bundle: BundleReader):
    """A TF2 signature frozen as tpudl's v2 route names it: (GraphDef,
    in_sig, out_sig). Raises :class:`FreezeError` where the signature is
    not one call of a function over its inputs and variable handles."""
    keys = [k for k in meta.signature_def if not k.startswith("__")]
    sig = meta.signature_def.get(signature_def_key)
    if sig is None:
        raise KeyError(f"SignatureDef {signature_def_key!r} not found; "
                       f"available: {sorted(keys)}")
    graph = meta.graph_def
    nodes = {n.name: n for n in graph.node}
    calls = {op_name(t.name) for t in sig.outputs.values()}
    call = nodes.get(next(iter(calls))) if len(calls) == 1 else None
    if call is None or call.op not in _CALL_OPS:
        raise FreezeError(f"signature {signature_def_key!r} is not one "
                          "function call")
    library = {f.signature.name: f for f in graph.library.function}
    fdef = library[call.attr["f"].func.name]
    var_keys = restore_keys(graph, meta.saver_def, aliases=True)
    body, rets = function_graph(fdef)
    inputs = []
    for arg, src in zip(fdef.signature.input_arg, call.input):
        main = nodes[op_name(src)]
        if main.op in ("Placeholder", "PlaceholderWithDefault"):
            inputs.append(pw.new("NodeDef", name=arg.name, op="Placeholder",
                                 attr={"dtype": pw.new("AttrValue",
                                                       type=arg.type),
                                       "shape": main.attr["shape"]}))
        elif main.op in VARIABLE_OPS:
            key = var_keys.get(main.name)
            if key is None or key not in bundle:
                raise FreezeError(f"variable {main.name!r} of signature "
                                  f"{signature_def_key!r} has no value in "
                                  "the bundle")
            inputs.append(_const_node(arg.name, bundle, key))
        else:
            raise FreezeError(f"signature input {src!r} is a {main.op}")
    gdef = pw.new("GraphDef", node=inputs + body, library=graph.library)
    in_sig = {}
    args = [op_name(s) for s in call.input]
    for name, info in sig.inputs.items():
        ph = op_name(info.name)
        if ph not in args:
            raise FreezeError(f"signature input {info.name!r} does not feed "
                              "the call")
        in_sig[name] = tensor_name(fdef.signature.input_arg[
            args.index(ph)].name)
    out_sig = {name: rets[int(tensor_name(info.name).split(":")[1])]
               for name, info in sig.outputs.items()}
    return gdef, dict(sorted(in_sig.items())), dict(sorted(out_sig.items()))
