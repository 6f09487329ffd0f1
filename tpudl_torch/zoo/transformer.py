"""TinyCausalLM — the small pre-norm causal decoder LM, as an ``nn.Module``.

Port of ``tpudl/zoo/transformer.py`` (``TinyCausalLM``: ``init``,
``hidden``/``apply``, ``_decoder_block``, ``init_cache``/``decode_step``/
``decode_step_slots``/``generate`` and the slot programs that
``tpudl_torch.serve`` runs). The math and the public layouts are tpudl's:
weights are kept in its ``x @ W`` orientation under its names (``embed.table``,
``blocks.<i>.wq``, …), attention works on ``[B, S, H, D]``, and
:func:`load_jax_params` fills the module from tpudl's numpy param pytree,
so both packages run the same model from the same ``init(seed)``.

The full-sequence forward (:meth:`TinyCausalLM.hidden`) runs attention
through :func:`tpudl_torch.cuda_ops.flash_attention` (the hand-written
CUDA kernels on the card, forward and, under autograd, backward), and
:meth:`TinyCausalLM.loss_fn` is tpudl's next-token training loss. The
KV-cache decode step keeps tpudl's dense masked attention over the cache,
with the position as a device tensor, so that one captured CUDA graph
serves every position. The cache is updated in place (``decode_step``
returns the same list it was given) — JAX had to return a new one.
:func:`to_jax_params` carries the module's weights back to tpudl's numpy
param pytree.

tpudl's parallelism matrix, on a local :class:`~tpudl_torch.mesh.Mesh`
(one process driving a ``(data, model)`` grid of cards):

- SP: ``hidden``/``apply``/``loss_fn(mesh=)`` split the sequence over the
  data axis, and each block's attention is the flash-kernel ring
  (:func:`tpudl_torch.attention.ring`); every other op of a block runs on
  the card that holds its sequence block;
- TP: ``tp=True`` splits heads and the MLP's hidden dim over the model
  axis (Megatron's column/row layout, :meth:`TinyCausalLM.
  param_shardings`), with one differentiable sum over the axis after the
  attention projection and one after the MLP
  (:func:`tpudl_torch.mesh.all_sum`). :meth:`TinyCausalLM.shard_params`
  lays the split leaves out on their cards, in place, so that each card
  holds 1/N of them and the optimizer steps each shard where it lives;
  the KV-cache decode, ``generate`` and the slot programs take
  ``tp=True`` too, with the cache split over heads;
- EP: ``experts=N`` swaps each block's MLP for tpudl's top-1 switch MoE
  (capacity ``ceil(S·cf/N)`` a row, tokens over it pass on the
  residual); under ``tp=True`` the experts are split over the model axis:
  the tokens' dispatch buffers travel to their experts' cards and the
  expert weights stay put;
- PP: :meth:`TinyCausalLM.apply_pipelined`, tpudl's GPipe schedule
  (:func:`tpudl_torch.pipeline.pipeline_blocks`) with dense attention in
  the pipe.

A weight that a card other than its own needs is copied there inside the
autograd graph (``.to``), so its gradient sums back onto it.

Over a process group's mesh (``build_mesh(n_data, n_model)`` inside a
joined group, ``HorovodRunner`` under ``TPUDL_MESH_MODEL``; one card a
rank) each rank runs only its own entry of the grid, Megatron's way:
``hidden``/``apply``/``loss_fn(mesh=)`` take the whole batch on every rank
and run the rank's sequence block (block ``r`` for data-axis index ``r``;
the ring over the data axis, :func:`tpudl_torch.attention.ring_group`);
under ``tp=True`` the rank projects its ``heads/m`` heads and its slice of
the MLP, or runs its ``experts/m`` experts, and the row-parallel sums are
the collectives of :mod:`tpudl_torch.collectives` over its row (an
all-reduce whose backward is the identity, entered through the identity
whose backward is an all-reduce), so the leaves whole on every rank of a
row get equal gradients there. MoE's buffers travel to their experts'
ranks by ``all_to_all``. ``shard_params`` keeps only the rank's 1/m of
each split leaf. ``loss_fn`` returns the global loss on every rank.
Decoding, serving and ``apply_pipelined`` over a group are not ported
(ROADMAP Queue 1, 'LM parallelism').

The program store (:mod:`tpudl_torch.compile`, ``TPUDL_COMPILE_AOT``):
armed, greedy ``generate`` runs as ONE CUDA graph per geometry (batch,
padded prompt rung, ``max_new``, the tensor-parallel topology, dtype) —
the prefill over the padded rung, the logits of the real last position
picked on the card, decoding from device-tensor positions — so every
prompt of a rung shares one graph, as tpudl's ``_gen_program`` shares
one program; ``precompile_generate`` and ``precompile_serve`` capture
ahead of traffic; ``aot_token`` is tpudl's architecture identity. Sampled
decoding stays eager (a miss): drawing ``generate(generator=)``'s stream
inside a graph is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpudl_torch import collectives as C
from tpudl_torch import cuda_ops
from tpudl_torch import mesh as M
from tpudl_torch.attention import attention_reference, ring, ring_group
from tpudl_torch.compile.buckets import resolve_ladder
from tpudl_torch.device import resolve_device

__all__ = ["TinyCausalLM", "load_jax_params", "to_jax_params", "arch_of"]

# the dim a tensor-parallel leaf is split on over the model axis (tpudl's
# param_shardings): wq/wk/wv/w_up column-parallel, wo/w_down row-parallel,
# b_up with its columns, the experts' leaves on the expert dim
_SHARD_DIM = {"wq": 1, "wk": 1, "wv": 1, "w_up": 1, "b_up": 0, "wo": 0,
              "w_down": 0, "w_up_e": 0, "b_up_e": 0, "w_down_e": 0,
              "b_down_e": 0}


def arch_of(model) -> dict:
    """The constructor arguments of ``model``'s architecture (a
    :class:`TinyCausalLM`, or anything with its attributes)."""
    return dict(vocab=model.vocab, dim=model.dim, heads=model.heads,
                layers=model.layers, max_len=model.max_len,
                experts=getattr(model, "experts", 0),
                capacity_factor=getattr(model, "capacity_factor", 2.0))


def _shards(t) -> tuple:
    """A cache buffer's per-card shards: a tuple under ``tp=True`` over
    more than one card, else the one tensor."""
    return t if isinstance(t, tuple) else (t,)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to tpudl_torch yet (ROADMAP Queue 1, "
        f"{item!r})")


def _layer_norm(x, p, prefix=""):
    return F.layer_norm(x, (x.shape[-1],), p[prefix + "gamma"],
                        p[prefix + "beta"], eps=1e-5)


class TinyCausalLM(nn.Module):
    """A small pre-norm decoder LM: embed → [attn + mlp]×L → tied logits.

    Parameters are allocated as zeros on ``device`` (default ``"cuda"``);
    fill them with :func:`load_jax_params` (or build in one call with
    :meth:`from_jax_params`). The module trains like any other: gradients
    of :meth:`loss_fn` reach every parameter, through the flash backward
    kernels on the card."""

    def __init__(self, vocab: int = 256, dim: int = 64, heads: int = 4,
                 layers: int = 2, max_len: int = 4096, experts: int = 0,
                 capacity_factor: float = 2.0, *, device="cuda"):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.vocab = vocab
        self.dim = dim
        self.heads = heads
        self.layers = layers
        self.max_len = max_len
        self.experts = experts
        self.capacity_factor = capacity_factor
        # the program store's identity of the architecture (tpudl's): a
        # graph is always captured from this live module, so the weights
        # it reads are this module's
        self.aot_token = (f"TinyCausalLM:v{vocab}:d{dim}:h{heads}:"
                          f"l{layers}:m{max_len}:e{experts}:"
                          f"c{capacity_factor}")
        # generate's graph functions, one per geometry (the store's table
        # holds their graphs)
        self._gen_fns: dict = {}
        # the model-axis cards of shard_params' layout (None: one device)
        self._tp_devices = None
        # the process group's mesh of shard_params' layout (None: whole)
        self._tp_group = None
        # a list to record each MoE layer's (choice, kept) routing into
        self.moe_routes = None
        dev = resolve_device(device)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        d, e = dim, experts

        def block():
            leaves = {
                "norm1_gamma": zeros(d), "norm1_beta": zeros(d),
                "wq": zeros(d, d), "wk": zeros(d, d), "wv": zeros(d, d),
                "wo": zeros(d, d),
                "norm2_gamma": zeros(d), "norm2_beta": zeros(d)}
            if e:
                leaves.update({
                    "w_gate": zeros(d, e), "w_up_e": zeros(e, d, 4 * d),
                    "b_up_e": zeros(e, 4 * d), "w_down_e": zeros(e, 4 * d, d),
                    "b_down_e": zeros(e, d)})
            else:
                leaves.update({
                    "w_up": zeros(d, 4 * d), "b_up": zeros(4 * d),
                    "w_down": zeros(4 * d, d), "b_down": zeros(d)})
            return nn.ParameterDict(leaves)

        self.embed = nn.ParameterDict({"table": zeros(vocab, d)})
        self.final_norm = nn.ParameterDict({"gamma": zeros(d),
                                            "beta": zeros(d)})
        self.blocks = nn.ModuleList(block() for _ in range(layers))
        if dev.type != "meta":
            self._program_store()   # armed: warm_start may rebuild ours

    # -- the program store ---------------------------------------------------
    def _program_store(self):
        """The process's program store with this module registered as an
        owner of its generate graphs, or None when the store is unarmed."""
        from tpudl_torch.compile import store as S

        if not S.aot_enabled():
            return None
        store = S.get_program_store()
        store.register_owner(self)
        return store

    def _drop_programs(self) -> None:
        """Forget this module's graphs: they read parameter memory that is
        about to be replaced."""
        from tpudl_torch.compile import store as S

        # a deep copy shares the dict's functions, which are the original's
        S.forget(*(f for f in self._gen_fns.values()
                   if f.module_id == id(self)))
        self._gen_fns.clear()

    def _apply(self, fn, recurse=True):
        # .to(), .cuda(), .half(), ... swap every parameter's storage
        self._drop_programs()
        return super()._apply(fn, recurse)

    @classmethod
    def from_jax_params(cls, params, *, vocab: int, dim: int, heads: int,
                        layers: int, max_len: int = 4096, experts: int = 0,
                        capacity_factor: float = 2.0,
                        device="cuda") -> "TinyCausalLM":
        """Build the module on ``device`` and load tpudl's param pytree
        (numpy or jax arrays, whatever their shardings)."""
        model = cls(vocab, dim, heads, layers, max_len, experts,
                    capacity_factor, device=device)
        return load_jax_params(model, params)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # -- params -----------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        """tpudl's seeded numpy param pytree, bit-equal to
        ``tpudl.zoo.transformer.TinyCausalLM.init(seed)`` (same draws, same
        order). Load it with :func:`load_jax_params`."""
        rng = np.random.default_rng(seed)
        d, v = self.dim, self.vocab

        def w(*shape, scale=None):
            scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
            return (rng.normal(size=shape) * scale).astype(np.float32)

        params: dict = {
            "embed": {"table": w(v, d, scale=0.02)},
            "final_norm": {"gamma": np.ones(d, np.float32),
                           "beta": np.zeros(d, np.float32)},
        }
        for i in range(self.layers):
            block = {
                "norm1_gamma": np.ones(d, np.float32),
                "norm1_beta": np.zeros(d, np.float32),
                "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
                "norm2_gamma": np.ones(d, np.float32),
                "norm2_beta": np.zeros(d, np.float32),
            }
            if self.experts:
                e = self.experts
                block.update({
                    "w_gate": w(d, e, scale=0.02),
                    "w_up_e": np.stack([w(d, 4 * d) for _ in range(e)]),
                    "b_up_e": np.zeros((e, 4 * d), np.float32),
                    "w_down_e": np.stack([w(4 * d, d) for _ in range(e)]),
                    "b_down_e": np.zeros((e, d), np.float32),
                })
            else:
                block.update({
                    "w_up": w(d, 4 * d), "b_up": np.zeros(4 * d, np.float32),
                    "w_down": w(4 * d, d),
                    "b_down": np.zeros(d, np.float32),
                })
            params[f"block_{i}"] = block
        return params

    # -- tensor parallelism ------------------------------------------------
    def _split_names(self) -> tuple:
        """The block leaves that tensor parallelism splits."""
        return tuple(n for n in self.blocks[0].keys() if n in _SHARD_DIM) \
            if self._tp_devices is None else tuple(self.tp_shards[0][0])

    def param_shardings(self, mesh, model_axis: str = M.MODEL_AXIS) -> dict:
        """tpudl's Megatron layout over ``mesh[model_axis]``, as a pytree of
        :class:`~tpudl_torch.mesh.NamedSharding` shaped like the param
        pytree: wq/wk/wv and w_up column-parallel (output dim split: each
        card computes its own heads and hidden slice), wo and w_down
        row-parallel (input dim split: one sum over the axis after each),
        the experts' leaves split on the expert dim; embedding, norms,
        ``w_gate`` and ``b_down`` whole on every card."""
        self._check_split(mesh.shape[model_axis], model_axis)

        def spec(t, dim=None):
            axes = [None] * t.dim()
            if dim is not None:
                axes[dim] = model_axis
            return M.NamedSharding(mesh, tuple(axes))

        out = {"embed": {"table": spec(self.embed["table"])},
               "final_norm": {k: spec(t)
                              for k, t in self.final_norm.items()}}
        for i in range(self.layers):
            leaves = dict(self.blocks[i].items())
            if self._tp_devices is not None:
                leaves.update(self.tp_shards[0][i].items())
            out[f"block_{i}"] = {k: spec(t, _SHARD_DIM.get(k))
                                 for k, t in leaves.items()}
        return out

    def _check_split(self, n: int, model_axis: str = M.MODEL_AXIS):
        """Raise unless heads, the MLP's hidden dim and the experts
        divide over ``n`` model-axis entries."""
        if self.heads % n or (4 * self.dim) % n:
            raise ValueError(
                f"heads {self.heads} and mlp hidden {4 * self.dim} must "
                f"divide the {model_axis!r} axis size {n}")
        if self.experts and self.experts % n:
            raise ValueError(
                f"experts {self.experts} must divide the {model_axis!r} "
                f"axis size {n}")

    def shard_params(self, mesh, model_axis: str = M.MODEL_AXIS):
        """Lay the module out by :meth:`param_shardings`, in place: each
        split leaf becomes one parameter a model-axis card (its 1/N slice,
        on ``mesh``'s first row of cards, ``tp_shards.<card>.<block>.
        <name>``), the whole leaves stay where they are. Build the
        optimizer after this: it then steps every slice on its card. A
        model axis of 1 puts the leaves back together. Returns the
        module. Under an explicit ``TPUDL_DATA_HBM_BUDGET_MB`` the layout
        is checked first (:func:`~tpudl_torch.mesh.require_hbm_fit`): a
        card's share over the budget raises ``DeviceOOM`` before any
        leaf moves."""
        M.require_hbm_fit(self._param_tree(), self.param_shardings(
            mesh, model_axis), what=f"{self.aot_token} params")
        if not mesh.local:
            return self._shard_over_group(mesh, model_axis)
        if self._tp_group is not None:
            raise ValueError("the module is laid out over a process group's "
                             "mesh; it keeps that layout")
        n = mesh.shape[model_axis]
        self._check_split(n, model_axis)
        devs = tuple(mesh.entry(model_axis, j) for j in range(n))
        if devs == self._tp_devices or (n == 1 and self._tp_devices is None):
            return self
        self._drop_programs()   # their graphs read the leaves that move
        with torch.no_grad():
            names = self._split_names()
            whole = [{k: t.detach() for k, t in self._block_leaves(i).items()
                      if k in names} for i in range(self.layers)]
            if self._tp_devices is not None:
                del self.tp_shards
            for i, p in enumerate(self.blocks):
                for k in names:
                    if k in p:
                        del p[k]
            if n == 1:
                for i, p in enumerate(self.blocks):
                    for k in names:
                        p[k] = nn.Parameter(whole[i][k].to(self.device))
                self._tp_devices = None
                return self

            def part(t, k, j):
                width = t.shape[_SHARD_DIM[k]] // n
                return nn.Parameter(t.narrow(_SHARD_DIM[k], j * width, width)
                                    .to(devs[j]).clone())

            self.tp_shards = nn.ModuleList(
                nn.ModuleList(nn.ParameterDict(
                    {k: part(whole[i][k], k, j) for k in names})
                    for i in range(self.layers))
                for j in range(n))
        self._tp_devices = devs
        return self

    def _param_tree(self) -> dict:
        """The whole leaves' shapes and dtypes, as meta tensors, in
        :meth:`param_shardings`' layout: what a placement must hold,
        with nothing gathered or copied."""
        def whole(t, k=None, n=1):
            shape = list(t.shape)
            if k is not None:
                shape[_SHARD_DIM[k]] *= n
            return torch.empty(shape, dtype=t.dtype, device="meta")

        split = set(self._split_names()) if self._tp_group is not None \
            else set()
        n_group = (self._tp_group.shape[M.MODEL_AXIS] if split else 1)
        tree = {"embed": {k: whole(t) for k, t in self.embed.items()},
                "final_norm": {k: whole(t)
                               for k, t in self.final_norm.items()}}
        for i in range(self.layers):
            leaves = {k: whole(t, k if k in split else None, n_group)
                      for k, t in self.blocks[i].items()}
            if self._tp_devices is not None:
                leaves.update({k: whole(t, k, len(self._tp_devices))
                               for k, t in self.tp_shards[0][i].items()})
            tree[f"block_{i}"] = leaves
        return tree

    def _shard_over_group(self, mesh, model_axis: str):
        """:meth:`shard_params` over a process group's mesh: this rank keeps
        slice ``j`` (its index on the model axis) of each split leaf, in
        place of the leaf."""
        n = mesh.shape[model_axis]
        self._check_split(n, model_axis)
        if self._tp_devices is not None:
            raise ValueError(
                "the module is laid out over a local mesh; put it back "
                "together first (shard_params over a model axis of 1)")
        if self._tp_group is not None:
            if _same_entry(self._tp_group, mesh):
                return self
            raise ValueError("the module is laid out over another process "
                             "group's mesh")
        if n == 1:
            return self
        j = mesh.axis_index(model_axis)
        self._drop_programs()   # their graphs read the leaves that change
        with torch.no_grad():
            for p in self.blocks:
                for k in self._split_names():
                    dim = _SHARD_DIM[k]
                    width = p[k].shape[dim] // n
                    p[k] = nn.Parameter(
                        p[k].detach().narrow(dim, j * width, width).clone())
        self._tp_group = mesh
        return self

    def split_parameters(self) -> list:
        """The parameters that a process group's layout
        (:meth:`shard_params`) split over the model axis, each with its
        split dim: ``[(param, dim)]``; empty for any other layout."""
        if self._tp_group is None:
            return []
        names = self._split_names()
        return [(p[k], _SHARD_DIM[k]) for p in self.blocks for k in names]

    def _block_leaves(self, i: int):
        """Block ``i``'s leaves, whole: its ``ParameterDict`` itself, or
        under a tensor-parallel layout a dict whose split leaves are put
        back together on the module's device (differentiably; over a
        process group by a gather over the row, which every rank of it
        must call)."""
        p = self.blocks[i]
        if self._tp_group is not None:
            row = self._tp_group.axis_group(M.MODEL_AXIS)
            names = self._split_names()
            return {k: C.gather(t, row, dim=_SHARD_DIM[k]) if k in names
                    else t for k, t in p.items()}
        if self._tp_devices is None:
            return p
        leaves = dict(p.items())
        for k, t in self.tp_shards[0][i].items():
            leaves[k] = torch.cat([sh[i][k].to(self.device)
                                   for sh in self.tp_shards],
                                  dim=_SHARD_DIM[k])
        return leaves

    def _entry_params(self, i: int, j: int, cols: int, dev) -> dict:
        """Block ``i``'s leaves as model-axis entry ``j`` of ``cols`` needs
        them on ``dev``: the whole leaves, and slice ``j`` of the split
        ones (the layout's own parameter where it matches)."""
        p = self.blocks[i]
        out = {k: t.to(dev) for k, t in p.items()
               if cols == 1 or k not in _SHARD_DIM}
        if cols == 1 and self._tp_devices is None:
            return out
        if self._tp_devices is not None and len(self._tp_devices) == cols:
            out.update({k: t.to(dev)
                        for k, t in self.tp_shards[j][i].items()})
            return out
        whole = self._block_leaves(i)
        for k in self._split_names():
            if cols == 1:
                out[k] = whole[k].to(dev)
                continue
            dim = _SHARD_DIM[k]
            width = whole[k].shape[dim] // cols
            out[k] = whole[k].narrow(dim, j * width, width).to(dev)
        return out

    def _grid(self, mesh, tp):
        """The ``[row][column]`` cards a forward over ``mesh`` runs on:
        one row a data-axis entry (its sequence block) and, under ``tp``,
        one column a model-axis entry (its heads, hidden slice and
        experts); None without a mesh."""
        if tp and (mesh is None or M.MODEL_AXIS not in mesh.shape):
            raise ValueError(
                "tp=True needs a mesh with a 'model' axis "
                "(tpudl_torch.mesh.build_mesh(n_data=..., n_model=..., "
                "devices=[...]))")
        if mesh is None:
            return None
        if not isinstance(mesh, M.Mesh):
            raise ValueError(
                f"mesh={mesh!r}: TinyCausalLM runs over a local mesh "
                "(build_mesh(devices=[...])) or a process group's "
                "(build_mesh(n_data, n_model) inside a joined group)")
        cols = mesh.shape[M.MODEL_AXIS] if tp else 1
        if not mesh.local:      # this rank's own entry
            self._check_split(cols)
            return [[self.device]]
        self._check_split(cols)
        return [[torch.device(mesh.grid[r][j]) for j in range(cols)]
                for r in range(mesh.shape[M.DATA_AXIS])]

    # -- forward ----------------------------------------------------------
    def apply(self, tokens, *, mesh=None, use_pallas: bool = False,
              remat: bool = False, tp: bool = False):
        """tokens ``[B, S]`` int → logits ``[B, S, vocab]`` (tied head).
        tpudl's name; it shadows ``nn.Module.apply(fn)``. ``mesh``,
        ``tp`` and ``remat`` as :meth:`hidden` takes them."""
        grid = self._grid(mesh, tp)
        if grid is None or not mesh.local:
            x = self.hidden(tokens, mesh=mesh, remat=remat, tp=tp)
            return x @ self.embed["table"].T
        xs, tables = self._grid_hidden(tokens, grid, remat)
        return torch.cat([(x @ t.T).to(self.device)
                          for x, t in zip(xs, tables)], dim=1)

    forward = apply

    def hidden(self, tokens, *, mesh=None, use_pallas: bool = False,
               remat: bool = False, tp: bool = False):
        """tokens ``[B, S]`` int → final-norm hidden states ``[B, S, D]``:
        :meth:`apply` minus the head. Causal attention runs the flash
        kernel (12 launches for a 12-layer model). ``remat=True``
        checkpoints each block (``torch.utils.checkpoint``, the
        counterpart of tpudl's ``jax.checkpoint``): its activations are
        recomputed in the backward, so the forward kernel runs twice per
        block per training step.

        With a local ``mesh`` the sequence splits over its data axis (it
        must divide by the axis) and each block's attention is the
        flash-kernel ring: ``n(n+1)/2`` forward launches a block over
        ``n`` entries. ``tp=True`` also splits every block over the
        model axis (see the module docstring). The result comes back
        whole on the module's device. Over a process group's mesh
        ``tokens`` is the whole batch on every rank and the result is the
        rank's sequence block (block ``r`` for data-axis index ``r``): the
        ring of ``r + 1`` hops a block over the data axis, the rank's
        heads, MLP slice and experts under ``tp``. ``use_pallas`` is
        accepted and
        changes nothing: tpudl picks between its plain path and its
        Pallas kernel, which it proves equal; here both run the flash
        kernels."""
        grid = self._grid(mesh, tp)
        if grid is not None and not mesh.local:
            return self._group_hidden(tokens, mesh, tp, remat)
        if grid is not None:
            xs, _ = self._grid_hidden(tokens, grid, remat)
            return torch.cat([x.to(self.device) for x in xs], dim=1)
        b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_len {self.max_len}")
        x = F.embedding(tokens, self.embed["table"])

        def attn(q, k, v):
            return cuda_ops.flash_attention(q, k, v, causal=True)

        for i in range(self.layers):
            p = self._block_leaves(i)
            if remat:
                x = checkpoint(self._decoder_block, x, p, attn,
                               use_reentrant=False)
            else:
                x = self._decoder_block(x, p, attn)
        return _layer_norm(x, self.final_norm)

    def _grid_hidden(self, tokens, grid, remat):
        """The forward over ``grid``: each row's final-norm hidden states
        (its sequence block, on the row's first card) and the embedding
        table on that card."""
        b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_len {self.max_len}")
        rows, cols = len(grid), len(grid[0])
        if s % rows:
            raise ValueError(
                f"sequence length {s} not divisible by ring size {rows}")
        tables = [self.embed["table"].to(row[0]) for row in grid]
        xs = []
        for r, tok in enumerate(tokens.chunk(rows, dim=1)):
            x = F.embedding(tok.to(grid[r][0]), tables[r])
            xs.append([x.to(d) for d in grid[r]])
        attend = _ring_attend(grid)
        for i in range(self.layers):
            if not remat:
                xs = self._grid_block(xs, self._grid_params(i, grid), grid,
                                      attend)
                continue

            def run(*flat, i=i):
                grid_xs = [list(flat[r * cols:(r + 1) * cols])
                           for r in range(rows)]
                out = self._grid_block(grid_xs, self._grid_params(i, grid),
                                       grid, attend)
                return tuple(t for row in out for t in row)

            flat = checkpoint(run, *(t for row in xs for t in row),
                              use_reentrant=False)
            xs = [list(flat[r * cols:(r + 1) * cols]) for r in range(rows)]
        out = []
        for r, row in enumerate(grid):
            norm = {k: t.to(row[0]) for k, t in self.final_norm.items()}
            out.append(_layer_norm(xs[r][0], norm))
        return out, tables

    def _group_hidden(self, tokens, mesh, tp, remat):
        """:meth:`hidden` over a process group's mesh: this rank's sequence
        block of the final-norm hidden states."""
        b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_len {self.max_len}")
        n, r = mesh.shape[M.DATA_AXIS], mesh.axis_index(M.DATA_AXIS)
        if s % n:
            raise ValueError(
                f"sequence length {s} not divisible by ring size {n}")
        s_loc = s // n
        tok = torch.as_tensor(tokens)[:, r * s_loc:(r + 1) * s_loc]
        x = F.embedding(tok.to(self.device), self.embed["table"])
        grid = [[x.device]]

        def attend(qs, ks, vs):
            return [[ring_group(qs[0][0], ks[0][0], vs[0][0], mesh,
                                causal=True, use_pallas=True)]]

        for i in range(self.layers):
            def run(x, p=self._rank_params(i, mesh, tp)):
                return self._grid_block([[x]], [[p]], grid, attend,
                                        (mesh, tp))[0][0]

            x = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        return _layer_norm(x, self.final_norm)

    def _rank_params(self, i: int, mesh, tp) -> dict:
        """Block ``i``'s leaves as this rank of a process group's mesh needs
        them: the whole leaves and, under ``tp``, its slice of the split
        ones (the layout's own parameters where :meth:`shard_params` laid
        the module out over this mesh)."""
        m = mesh.shape[M.MODEL_AXIS] if tp else 1
        if (self._tp_group is not None and m > 1
                and _same_entry(self._tp_group, mesh)):
            return self.blocks[i]
        whole = self._block_leaves(i)
        if m == 1:
            return whole
        j, names = mesh.axis_index(M.MODEL_AXIS), self._split_names()
        row = mesh.axis_group(M.MODEL_AXIS)
        out = dict(whole.items())
        for k in names:
            # every rank of the row holds the whole leaf: entered through
            # copy_in, each gets the gradient of all the row's slices
            width = out[k].shape[_SHARD_DIM[k]] // m
            out[k] = C.copy_in(out[k], row).narrow(_SHARD_DIM[k],
                                                   j * width, width)
        return out

    def _grid_params(self, i: int, grid) -> list:
        """Block ``i``'s leaves for every entry of ``grid``
        (:meth:`_entry_params`), ``[row][column]``."""
        cols = len(grid[0])
        return [[self._entry_params(i, j, cols, dev)
                 for j, dev in enumerate(row)] for row in grid]

    def _grid_block(self, xs, ps, grid, attend, group=None):
        """ONE pre-norm decoder block over ``grid``, the single definition
        of the block math: ``xs[r][j]`` is row ``r``'s activations on card
        ``grid[r][j]`` (whole on every card of the row), ``ps[r][j]`` that
        entry's leaves. Each card projects its heads, ``attend`` runs the
        attention of every entry, and the row-parallel products (``wo``,
        ``w_down``, the experts' combine) sum over the row
        (:func:`~tpudl_torch.mesh.all_sum`): Megatron's split, which on a
        one-card grid is the plain block. ``group`` is ``(mesh, tp)`` for
        this rank's entry of a process group's mesh (``grid`` its one
        card): under ``tp`` the row is the mesh's model axis, and its sums
        are :func:`tpudl_torch.collectives.reduce_sum`, entered through
        :func:`~tpudl_torch.collectives.copy_in`. The MLP's gelu is the
        tanh approximation, jax.nn.gelu's default."""
        rows, cols = len(grid), len(grid[0])
        row = None
        if group is not None and group[1]:
            row = group[0].axis_group(M.MODEL_AXIS)
        split = cols * C.group_size(row)
        heads = self.heads // split
        qkv = [[self._qkv(xs[r][j], ps[r][j], heads, row)
                for j in range(cols)] for r in range(rows)]
        att = attend(*([[e[n] for e in row_] for row_ in qkv]
                       for n in range(3)))
        x2, h2 = [], []
        for r in range(rows):
            b, s = xs[r][0].shape[:2]
            parts = [att[r][j].reshape(b, s, self.dim // split)
                     @ ps[r][j]["wo"] for j in range(cols)]
            x2.append([x + t for x, t in
                       zip(xs[r], _row_sum(parts, grid[r], row))])
            h2.append([_layer_norm(x2[r][j], ps[r][j], "norm2_")
                       for j in range(cols)])
        if self.experts:
            moe = (self._grid_moe(h2, ps, grid) if group is None
                   else [[self._group_moe(h2[0][0], ps[0][0], *group)]])
            return [[x + t for x, t in zip(x2[r], moe[r])]
                    for r in range(rows)]
        out = []
        for r in range(rows):
            sums = _row_sum([self._ffn(C.copy_in(h2[r][j], row), ps[r][j])
                             for j in range(cols)], grid[r], row)
            out.append([x2[r][j] + sums[j] + ps[r][j]["b_down"]
                        for j in range(cols)])
        return out

    def apply_pipelined(self, tokens, mesh, *, pipe_axis: str = M.MODEL_AXIS,
                        n_micro: int = 2, data_axis: str | None = None,
                        remat: bool = False):
        """Forward pass with the decoder blocks PIPELINED over
        ``mesh[pipe_axis]`` (tpudl's GPipe schedule,
        :func:`tpudl_torch.pipeline.pipeline_blocks`): stage ``i`` runs
        blocks ``[i·L/n, (i+1)·L/n)`` on its card, and activations hop
        stage to stage. Embed and head run on the module's device, outside
        the pipe. ``data_axis`` also splits each microbatch over that
        axis (DP×PP). Attention inside the pipe is dense
        (:func:`~tpudl_torch.attention.attention_reference`), as in
        tpudl. ``batch % n_micro == 0``; MoE blocks are refused."""
        from tpudl_torch.pipeline import pipeline_blocks

        if not mesh.local:
            _not_ported("apply_pipelined over a process group's mesh",
                        "LM parallelism")
        if self.experts:
            raise NotImplementedError(
                "pipelined MoE blocks not supported; use apply(tp=True) "
                "for expert parallelism")
        b, s = tokens.shape
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by {n_micro} "
                             "microbatches")

        def block(x, p):
            return self._decoder_block(
                x, p, lambda q, k, v: attention_reference(q, k, v,
                                                          causal=True))

        x = F.embedding(tokens, self.embed["table"])          # [B, S, D]
        xm = x.reshape(n_micro, b // n_micro, s, self.dim)
        leaves = [self._block_leaves(i) for i in range(self.layers)]
        stacked = {k: torch.stack([p[k] for p in leaves])
                   for k in leaves[0].keys()}
        ym = pipeline_blocks(block, stacked, xm, mesh, axis=pipe_axis,
                             data_axis=data_axis, remat=remat)
        x = _layer_norm(ym.reshape(b, s, self.dim), self.final_norm)
        return x @ self.embed["table"].T

    def _qkv(self, x, p, heads: int, row=None):
        """The pre-norm and the q, k, v projections of ``heads`` heads,
        each ``[B, S, heads, head_dim]`` (entered over the process group
        ``row`` where a row splits the heads)."""
        b, s = x.shape[0], x.shape[1]
        h = C.copy_in(_layer_norm(x, p, "norm1_"), row)
        shape = (b, s, heads, self.dim // self.heads)
        return tuple((h @ p[w]).reshape(shape) for w in ("wq", "wk", "wv"))

    @staticmethod
    def _ffn(h, p):
        """The dense MLP before its output bias. The gelu is the tanh
        approximation, jax.nn.gelu's default."""
        return F.gelu(h @ p["w_up"] + p["b_up"], approximate="tanh") \
            @ p["w_down"]

    def _decoder_block(self, x, p, attn):
        """:meth:`_grid_block` on ``x``'s own device with the leaves ``p``:
        the full forward (flash ``attn``), the pipelined forward (dense
        ``attn``) and the KV-cache step (cached ``attn``)."""
        def attend(qs, ks, vs):
            return [[attn(qs[0][0], ks[0][0], vs[0][0])]]

        return self._grid_block([[x]], [[p]], [[x.device]], attend)[0][0]

    def _route(self, h, w_gate, offset=None):
        """tpudl's top-1 routing of ``h`` ``[B, S, D]``: (gate ``[B, S]``,
        expert choice ``[B, S]``, each token's place in its expert's
        buffer ``[B, S, E]``, −1 off its expert). ``offset`` ``[B, E]``
        counts the tokens routed to each expert in earlier sequence
        blocks."""
        probs = torch.softmax((h @ w_gate).float(), dim=-1)     # [B,S,E]
        gate, choice = probs.max(dim=-1)
        onehot = F.one_hot(choice, self.experts).float()
        count = torch.cumsum(onehot, dim=1)
        if offset is not None:
            count = count + offset[:, None, :]
        return gate, choice, count * onehot - 1.0

    def _capacity(self, s: int) -> int:
        return max(1, int(math.ceil(s * self.capacity_factor
                                    / self.experts)))

    @staticmethod
    def _dispatch(pos, gate, cap: int):
        """The one-hot dispatch ``[B, S, E, C]`` of tokens into their
        experts' buffers (0 past capacity) and the gate-weighted combine."""
        keep = ((pos >= 0) & (pos < cap)).float()
        slot = F.one_hot(pos.clamp(0, cap - 1).long(), cap).float()
        dispatch = slot * keep[..., None]
        return dispatch, dispatch * gate[..., None, None]

    @staticmethod
    def _experts(xe, p):
        """The experts' FFNs over their buffers ``[E, B, C, D]``."""
        u = F.gelu(torch.einsum("ebcd,edh->ebch", xe, p["w_up_e"].float())
                   + p["b_up_e"][:, None, None, :], approximate="tanh")
        return (torch.einsum("ebch,ehd->ebcd", u, p["w_down_e"].float())
                + p["b_down_e"][:, None, None, :])

    def _record_route(self, choice, pos, cap):
        if self.moe_routes is not None:
            kept = (pos.amax(dim=-1) < cap)
            self.moe_routes.append((choice.detach(), kept.detach()))

    def _grid_moe(self, hs, ps, grid):
        """tpudl's top-1-routed (switch) mixture-of-experts FFN over
        ``grid`` (``hs[r][j]`` the normed activations): the softmax gate
        picks ONE expert a token; tokens are packed into per-expert
        capacity buffers (``ceil(S·cf/E)`` a row, counted over the whole
        sequence, so each row's routing adds the earlier rows' counts) by
        a one-hot dispatch einsum, each expert's FFN runs on its buffer,
        and a combine einsum scatters the results back weighted by the
        gate. Tokens over capacity get nothing (the residual passes them
        on). Each card's buffers for its experts travel to the card that
        holds those experts (the row-0 card of its column), their FFNs run
        there, the outputs travel back and combine, and one sum over the
        row joins the experts."""
        rows, cols = len(grid), len(grid[0])
        per = self.experts // cols
        cap = self._capacity(sum(h[0].shape[1] for h in hs))
        combine, xe = {}, {}
        for j in range(cols):
            offset = None
            for r in range(rows):
                h = hs[r][j]
                gate, choice, pos = self._route(h, ps[r][j]["w_gate"],
                                                offset)
                if j == 0:
                    self._record_route(choice, pos, cap)
                counts = (pos >= 0).float().sum(dim=1)           # [B, E]
                offset = counts if offset is None else \
                    offset.to(h.device) + counts
                offset = offset.to(grid[(r + 1) % rows][j])
                d, c = self._dispatch(pos[..., j * per:(j + 1) * per],
                                      gate, cap)
                combine[r, j] = c
                xe[r, j] = torch.einsum("bsec,bsd->ebcd", d, h.float())
        out = [[None] * cols for _ in range(rows)]
        for j in range(cols):
            home = grid[0][j]
            ye = self._experts(M.sum_to([xe[r, j] for r in range(rows)],
                                        home), ps[0][j])
            for r in range(rows):
                out[r][j] = torch.einsum("bsec,ebcd->bsd", combine[r, j],
                                         ye.to(grid[r][j]))
        return [[t.to(hs[r][0].dtype) for t in M.all_sum(out[r], grid[r])]
                for r in range(rows)]

    def _group_moe(self, h, p, mesh, tp):
        """:meth:`_grid_moe` on this rank's entry of a process group's mesh
        (``h`` its sequence block's normed activations). The capacity and
        the routing count over the whole sequence: the earlier data-axis
        blocks' counts come over the data axis. Under ``tp`` each rank of
        the row packs the buffers of its ``1/m`` of the batch rows for
        every expert; ``all_to_all`` takes each expert's buffers to the rank
        that holds it (``experts/m`` a rank) and its outputs back, the rank
        combines its rows, and the rows join over the row. The batch must
        divide by the model axis."""
        row = mesh.axis_group(M.MODEL_AXIS) if tp else None
        m = C.group_size(row)
        n, r = mesh.shape[M.DATA_AXIS], mesh.axis_index(M.DATA_AXIS)
        b, s, d = h.shape
        cap = self._capacity(s * n)
        h = C.copy_in(h, row)
        gate, choice, pos = self._route(h, C.copy_in(p["w_gate"], row))
        if n > 1:
            # tokens routed to each expert in this row's earlier blocks
            onehot = (pos >= 0).float()
            counts = C.all_gather(onehot.sum(dim=1)[None],
                                  mesh.axis_group(M.DATA_AXIS))
            pos = pos + counts[:r].sum(dim=0)[:, None, :] * onehot
        self._record_route(choice, pos, cap)
        if m == 1:
            disp, comb = self._dispatch(pos, gate, cap)
            ye = self._experts(torch.einsum("bsec,bsd->ebcd", disp,
                                            h.float()), p)
            return torch.einsum("bsec,ebcd->bsd", comb, ye).to(h.dtype)
        if b % m:
            raise ValueError(f"batch {b} must divide over the model axis "
                             f"({m}) for the experts' all_to_all")
        bl, per, j = b // m, self.experts // m, mesh.axis_index(M.MODEL_AXIS)
        mine = slice(j * bl, (j + 1) * bl)
        disp, comb = self._dispatch(pos[mine], gate[mine], cap)
        xe = torch.einsum("bsec,bsd->ebcd", disp, h[mine].float())
        # [m sources x per experts, bl, C, D] -> [per, m x bl = b, C, D]
        xe = C.all_to_all(xe, row).view(m, per, bl, cap, d).transpose(0, 1)
        ye = self._experts(xe.reshape(per, b, cap, d), p)
        ye = ye.view(per, m, bl, cap, d).transpose(0, 1).reshape(
            m * per, bl, cap, d)
        out = torch.einsum("bsec,ebcd->bsd", comb, C.all_to_all(ye, row))
        return C.gather(out, row, dim=0).to(h.dtype)

    # -- autoregressive decode (KV cache) ----------------------------------
    def _decode_cards(self, mesh, tp):
        """The model-axis cards a ``tp=True`` decode splits its heads over
        (the mesh's first row), or None for a one-device decode."""
        grid = self._grid(mesh, tp)
        if mesh is not None and not mesh.local:
            _not_ported("generate, decode_step and serving over a process "
                        "group's mesh", "LM parallelism")
        if grid is not None and self.experts:
            raise NotImplementedError(
                "KV-cache decode for MoE blocks not supported")
        if grid is None or len(grid[0]) == 1:
            return None
        return grid[0]

    def init_cache(self, batch: int, max_len: int | None = None,
                   dtype=None, *, mesh=None, tp: bool = False) -> list:
        """Per-layer K/V buffers ``[B, max_len, heads, head_dim]`` of zeros
        (dtype follows the params unless given). ``tp=True`` over a mesh
        whose model axis is above 1 splits each buffer over heads: a tuple
        of ``[B, max_len, heads/N, head_dim]`` buffers, one on each
        model-axis card, so the cache's memory also scales by 1/N."""
        length = max_len or self.max_len
        dtype = dtype or self.embed["table"].dtype
        cards = self._decode_cards(mesh, tp)
        devs = cards or [self.device]
        shape = (batch, length, self.heads // len(devs),
                 self.dim // self.heads)

        def buf():
            bufs = tuple(torch.zeros(shape, dtype=dtype, device=d)
                         for d in devs)
            return bufs if cards else bufs[0]

        return [{"k": buf(), "v": buf()} for _ in range(self.layers)]

    def decode_step(self, tok, cache, pos, *, mesh=None, tp: bool = False):
        """One incremental step: token ids ``tok`` ``[B]`` at position
        ``pos`` → (logits ``[B, vocab]``, cache). Each block's K/V for the
        token are written into ``cache`` at ``pos`` (in place) and
        attention reads the cache masked to positions ``0..pos``.

        ``pos`` is an int (checked against the cache length) or a 0-d
        integer tensor on the model's device, which is not checked: the
        check would wait for the device, and a captured graph replays with
        whatever position the tensor holds. ``tp=True`` runs the step over
        the mesh's model axis, on a cache from ``init_cache(tp=True)``."""
        cards = self._decode_cards(mesh, tp)
        x = self._decode_hidden(tok, cache, self._pos_tensor(pos, cache),
                                cards)
        return self._logits(x), cache

    def decode_step_slots(self, tok, cache, pos, *, mesh=None,
                          tp: bool = False):
        """One decode step across ``S`` independent slots: token ids
        ``tok`` ``[S]`` at per-slot positions ``pos`` ``[S]`` (an integer
        tensor on the model's device) → (logits ``[S, vocab]``, cache) over
        a fixed ``[S, L, heads, head_dim]`` KV cache. tpudl's
        ``decode_step_slots``: each slot writes its K/V at its own
        position and attends to keys ``<= pos[s]`` (an ``[S, L]`` mask), so
        rows never mix and a slot decodes as a batch-1 ``decode_step`` at
        the same position would. Slots nobody occupies ride along: their
        write lands in a row that the next insert overwrites whole.
        ``tp=True`` as :meth:`decode_step` takes it."""
        cards = self._decode_cards(mesh, tp)
        return self._logits(self._decode_hidden(tok, cache, pos,
                                                cards)), cache

    def _pos_tensor(self, pos, cache):
        if isinstance(pos, torch.Tensor):
            return pos
        cache_len = _shards(cache[0]["k"])[0].shape[1]
        pos = int(pos)
        if not 0 <= pos < cache_len:
            raise ValueError(
                f"pos {pos} out of range for cache length {cache_len}")
        return torch.full((), pos, dtype=torch.int64, device=self.device)

    def _decode_hidden(self, tok, cache, pos, cards=None):
        """The decoder blocks of one cached step, before the final norm:
        ``[B, D]`` on the module's device. With ``cards`` (a ``tp=True``
        decode), each card attends over its heads' cache shard and the
        block runs as :meth:`_grid_block` over that one row."""
        if self.experts:
            raise NotImplementedError(
                "KV-cache decode for MoE blocks not supported")
        x = F.embedding(tok, self.embed["table"])[:, None]   # [B, 1, D]
        if cards is None:
            for i, layer_cache in enumerate(cache):
                x = self._decoder_block(x, self._block_leaves(i),
                                        _cached_attn(layer_cache, pos))
            return x[:, 0]
        at = [pos.to(d) for d in cards]
        xs = [[x.to(d) for d in cards]]
        for i, layer_cache in enumerate(cache):
            shards = [{"k": k, "v": v} for k, v in
                      zip(layer_cache["k"], layer_cache["v"])]

            def attend(qs, ks, vs, shards=shards):
                return [[_cached_attn(c, p)(q, k, v) for c, p, q, k, v in
                         zip(shards, at, qs[0], ks[0], vs[0])]]

            xs = self._grid_block(xs, self._grid_params(i, [cards]),
                                  [cards], attend)
        return xs[0][0][:, 0].to(self.device)

    def _logits(self, x):
        """Final norm and tied head of ``_decode_hidden``'s output."""
        return _layer_norm(x, self.final_norm) @ self.embed["table"].T

    # -- the serving programs (tpudl_torch.serve.SlotDecoder) --------------
    def _slot_step_program(self, temperature: float, *, mesh=None,
                           tp: bool = False):
        """tpudl's ``_slot_step_program``, as a function over the engine's
        state tensors ``(cache, tok [S], pos [S], steps [S], live [S],
        logits [S, vocab])`` — whose shapes are the geometry ``(slots,
        cache_len)`` — that updates them in place: one decode step of every
        slot into ``logits``, then ``pos`` and ``steps`` advance on live
        slots. Greedy (``temperature == 0``) also writes each slot's argmax
        into ``tok``; a sampling engine draws the next tokens from
        ``logits`` itself, one generator a slot. It reads no host value,
        so the engine captures it as one CUDA graph. ``tp=True`` runs the
        step over the mesh's model axis, on a cache split over heads."""
        self._decode_cards(mesh, tp)

        def run(cache, tok, pos, steps, live, logits):
            logits.copy_(self.decode_step_slots(tok, cache, pos, mesh=mesh,
                                                tp=tp)[0])
            if temperature <= 0:
                tok.copy_(logits.argmax(dim=-1))
            pos.add_(live)
            steps.add_(live)

        return run

    def _slot_prefill_program(self, *, mesh=None, tp: bool = False):
        """The insert program of tpudl's ``_slot_prefill_program``, in two
        parts over the engine's state tensors, both free of host values:

        - ``step(row, prompt, ppos, hidden)``: one prompt token — the
          token ``prompt[ppos]`` through the decoder blocks on the batch-1
          ``row`` cache, its hidden state into ``hidden``, ``ppos`` on by
          one. Run ``real_plen`` times, it is tpudl's scan over the prompt
          stopped at the real length; the pad steps it leaves out only
          wrote cache positions that decoding overwrites before any step
          attends them, so the tokens are the same;
        - ``finish(row, cache, hidden, ppos, slot, tok, pos, steps, live,
          logits)``: the logits at ``real_plen - 1`` into ``logits`` (the
          head runs once, not at every prompt token), the greedy first
          token into ``tok[slot]``, the whole row into the slot cache at
          the device index ``slot`` (which also wipes the slot's previous
          occupant), ``pos[slot] = real_plen``, ``steps[slot] = 1`` and
          ``live[slot] = 1``.

        ``tp=True`` runs both over the mesh's model axis, on caches split
        over heads (each card writes its own shard)."""
        cards = self._decode_cards(mesh, tp)

        def step(row, prompt, ppos, hidden):
            tok = prompt.index_select(0, ppos.view(1))
            hidden.copy_(self._decode_hidden(tok, row, ppos, cards))
            ppos.add_(1)

        def finish(row, cache, hidden, ppos, slot, tok, pos, steps, live,
                   logits):
            logits.copy_(self._logits(hidden))
            tok.index_copy_(0, slot, logits.argmax(dim=-1))
            for r, c in zip(row, cache):
                for key in ("k", "v"):
                    for rs, cs in zip(_shards(r[key]), _shards(c[key])):
                        cs.index_copy_(0, slot.to(cs.device), rs)
            pos.index_copy_(0, slot, ppos.view(1))
            steps.index_fill_(0, slot, 1)
            live.index_fill_(0, slot, 1)

        return step, finish

    def precompile_serve(self, *, slots: int, cache_len: int,
                         prompt_rungs=None, temperature: float = 0.0,
                         mesh=None, tp: bool = False, block: bool = True,
                         engine=None) -> int:
        """Ready the serve loop's programs through the program store (on
        the card, capture their CUDA graphs: the decode step, the batch-1
        prefill step and the insert), so that a serving process's first
        request replays. Returns how many programs it made ready; 0 when
        the store is unarmed (tpudl's ``precompile_serve``). The programs
        run in place over an engine's state: ``engine`` is the
        :class:`~tpudl_torch.serve.SlotDecoder` to ready (the registry
        passes its own), else one is built over this module.
        ``prompt_rungs`` is accepted: one batch-1 prefill graph serves
        every prompt length, so there is no program a rung. ``block`` is
        accepted; the captures run now."""
        from tpudl_torch.compile import store as S

        if not S.aot_enabled():
            return 0
        if engine is None:
            from tpudl_torch.serve.slots import SlotDecoder

            engine = SlotDecoder(self, slots=slots, cache_len=cache_len,
                                 temperature=temperature, mesh=mesh, tp=tp)
        return engine.warm()

    def _gen_bucket(self, plen: int, max_new: int, prompt_buckets) -> int:
        """Padded prompt length: the smallest ladder rung ≥ plen that
        still fits ``max_len`` with ``max_new`` to go (``None`` = exact)."""
        ladder = resolve_ladder(prompt_buckets)
        if ladder is None:
            return plen
        return max(plen, min(ladder.pick(plen), self.max_len - max_new))

    def _one_card(self, mesh, tp) -> bool:
        """Whether a decode runs on one device (what one graph can hold)."""
        cards = self._decode_cards(mesh, tp)
        return cards is None or len(set(map(str, cards))) == 1

    def _gen_program(self, b: int, padded: int, max_new: int, *, mesh=None,
                     tp: bool = False):
        """The greedy generate function of one geometry ``(batch, PADDED
        prompt length, max_new)``: ``run(prompt [b, padded] int32,
        real_plen 0-d int64)`` → ``[b, max_new]`` int32, reading no host
        value, so that one CUDA graph serves every prompt of the rung
        (tpudl's ``_gen_program``). The prefill runs over the padded rung;
        the logits of position ``real_plen - 1`` are picked on the card
        (``torch.where``); decoding writes at ``real_plen + i`` from device
        tensors, overwriting each pad slot before any step attends it, so
        the tokens are eager ``generate``'s. Cached per geometry; the
        program store's table bounds the graphs."""
        topo = (tuple(sorted((str(k), int(v))
                             for k, v in mesh.shape.items()))
                if tp and mesh is not None else None)
        dtype = self.embed["table"].dtype
        key = (int(b), int(padded), int(max_new), topo, dtype)
        fn = self._gen_fns.get(key)
        if fn is not None and fn.module_id == id(self):
            return fn
        b, padded, max_new = key[:3]

        def run(prompt, real_plen):
            cache = self.init_cache(b, padded + max_new, mesh=mesh, tp=tp)
            at = torch.arange(padded + max_new, device=self.device)
            last = real_plen - 1
            best = None
            for pos in range(padded):
                logits, cache = self.decode_step(prompt[:, pos], cache,
                                                 at[pos], mesh=mesh, tp=tp)
                best = logits if best is None else torch.where(
                    at[pos] == last, logits, best)
            out = [_pick(best, 0.0, None)]
            for i in range(1, max_new):
                logits, cache = self.decode_step(out[-1], cache,
                                                 real_plen + (i - 1),
                                                 mesh=mesh, tp=tp)
                out.append(_pick(logits, 0.0, None))
            return torch.stack(out, dim=1)

        run.aot_token = (f"{self.aot_token}:generate:b{b}:p{padded}:"
                         f"n{max_new}:tp{topo}:{str(dtype)[6:]}")
        run.module_id = id(self)
        self._gen_fns[key] = run
        return run

    def _gen_args(self, b: int, padded: int, plen: int, prompt=None):
        """A generate graph's arguments: the prompt padded to ``padded``
        with zeros (zeros when None) and the real length on the card."""
        dev = self.device
        if prompt is None:
            prompt = torch.zeros((b, padded), dtype=torch.int32, device=dev)
        elif prompt.shape[1] < padded:
            prompt = F.pad(prompt, (0, padded - prompt.shape[1]))
        return prompt, torch.full((), int(plen), dtype=torch.int64,
                                  device=dev)

    def _gen_spec(self, b: int, padded: int, max_new: int, mesh) -> dict:
        """The manifest's descriptor of a generate graph, from which
        :meth:`_aot_rebuild` makes it again in another process (None under
        a mesh, which that process would have to hold too)."""
        if mesh is not None:
            return None
        return {"owner": self.aot_token, "kind": "generate", "batch": b,
                "padded": padded, "max_new": max_new}

    def _aot_rebuild(self, spec):
        """The program store's rebuild of a manifest entry this module
        owns: ``(fn, example args)`` of a generate geometry, or None."""
        if not isinstance(spec, dict) or spec.get("kind") != "generate" \
                or self.device.type == "meta":
            return None
        b, padded, max_new = (int(spec[k]) for k in ("batch", "padded",
                                                     "max_new"))
        if padded + max_new > self.max_len:
            return None
        return (self._gen_program(b, padded, max_new),
                self._gen_args(b, padded, padded))

    @torch.inference_mode()
    def generate(self, prompt, max_new: int, *, temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 prompt_buckets=None, mesh=None, tp: bool = False):
        """Autoregressive continuation: ``prompt`` ``[B, P]`` ints →
        ``[B, max_new]`` int32 on the model's device. Prefill runs
        :meth:`decode_step` over the prompt, generation feeds each pick
        back in. ``temperature=0`` is greedy argmax; otherwise softmax
        sampling drawn from ``generator`` (a ``torch.Generator`` on the
        model's device).

        ``prompt_buckets`` sizes the KV cache as tpudl does (the prompt's
        ladder rung + ``max_new``). The prefill stops at the real prompt
        length: tpudl's extra steps over pad tokens only wrote cache slots
        that generation overwrites before any step attends them, so the
        tokens are the same. ``tp=True`` decodes over the mesh's model
        axis, heads and KV cache split over its cards.

        With the program store armed (``TPUDL_COMPILE_AOT``) a greedy call
        on one device runs through it: the geometry's graph
        (:meth:`_gen_program`) replays, or the call runs it eagerly and
        captures it. A sampled call stays eager and counts a miss."""
        self._decode_cards(mesh, tp)
        prompt = torch.as_tensor(prompt, dtype=torch.int32,
                                 device=self.device)
        b, plen = prompt.shape
        if plen + max_new > self.max_len:
            raise ValueError(f"prompt {plen} + max_new {max_new} exceeds "
                             f"max_len {self.max_len}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if plen < 1:
            raise ValueError(f"prompt must hold >= 1 token, got shape "
                             f"{tuple(prompt.shape)}")
        if temperature > 0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs generator=")
        padded = self._gen_bucket(plen, max_new, prompt_buckets)
        store = self._program_store() if self._one_card(mesh, tp) else None
        if store is not None:
            if temperature <= 0:
                fn = self._gen_program(b, padded, max_new, mesh=mesh, tp=tp)
                return store.call(fn, self._gen_args(b, padded, plen, prompt),
                                  program=self._gen_spec(b, padded, max_new,
                                                         mesh))
            store.count_miss()   # sampled: eager, see precompile_generate
        cache = self.init_cache(b, padded + max_new, mesh=mesh, tp=tp)
        # the positions as device scalars: views into one tensor
        at = torch.arange(padded + max_new, device=self.device)
        for pos in range(plen):
            logits, cache = self.decode_step(prompt[:, pos], cache, at[pos],
                                             mesh=mesh, tp=tp)
        out = [_pick(logits, temperature, generator)]
        for i in range(1, max_new):
            logits, cache = self.decode_step(out[-1], cache, at[plen + i - 1],
                                             mesh=mesh, tp=tp)
            out.append(_pick(logits, temperature, generator))
        return torch.stack(out, dim=1)

    def precompile_generate(self, batch: int, prompt_len: int, max_new: int,
                            *, temperature: float = 0.0,
                            prompt_buckets=None, mesh=None, tp: bool = False,
                            block: bool = True) -> bool:
        """Capture the generate graph of one declared serving geometry
        through the program store, ahead of traffic (tpudl's
        ``precompile_generate``): with ``prompt_buckets`` the declared
        length snaps to its rung, so one capture covers every prompt of
        the rung. Returns True when the graph is ready, False when the
        store is unarmed or the decode spans several cards (one graph runs
        on one card). Sampled decoding (``temperature > 0``) is not
        captured: it raises ``NotImplementedError``."""
        from tpudl_torch.compile import store as S

        if not S.aot_enabled():
            return False
        if temperature > 0:
            _not_ported("precompile_generate(temperature > 0): sampled "
                        "decoding in a CUDA graph (sampled generate runs "
                        "eagerly)", "Compile")
        if not self._one_card(mesh, tp):
            return False
        store = self._program_store()
        padded = self._gen_bucket(int(prompt_len), int(max_new),
                                  prompt_buckets)
        fn = self._gen_program(int(batch), padded, int(max_new), mesh=mesh,
                               tp=tp)
        with torch.inference_mode():   # the zeros of the capture's warm-up
            args = self._gen_args(int(batch), padded, padded)
        return store.compile_signature(
            fn, args, program=self._gen_spec(int(batch), padded,
                                             int(max_new), mesh),
            block=block)

    # -- training loss -----------------------------------------------------
    def loss_fn(self, *, mesh=None, use_pallas: bool = False,
                remat: bool = False, tp: bool = False):
        """``loss(model, tokens)``: next-token cross-entropy of ``model``
        (a :class:`TinyCausalLM` of this architecture) on ``tokens``
        ``[B, S]``, the mean over the batch, with logits cast to f32 —
        tpudl's ``loss_fn``, with the module in the place of the param
        pytree. ``remat=True`` checkpoints each block (see :meth:`hidden`).

        ``use_pallas`` is accepted and changes nothing: tpudl picks
        between dense attention and its Pallas kernel, which it proves
        equal; here both run the flash op (the CUDA kernels on the card).
        With a local ``mesh`` the forward runs as :meth:`hidden` runs it
        there (the ring over the data axis, ``tp=True`` over the model
        axis; ``S - 1`` must divide by the data axis), and each sequence
        block's logits and summed cross-entropy stay on its card: only the
        sums travel.

        Over a process group's mesh every rank takes the whole batch and
        computes its sequence block's summed cross-entropy; the sums meet
        in :func:`tpudl_torch.collectives.psum` over the data axis, so
        every rank returns the global loss, and a train step's mean of the
        gradients over the data axis is the one-card gradient
        (:mod:`tpudl_torch.train.step`). When the data axis holds more than
        one rank, the returned function's ``whole_batch`` is True (the
        ``Trainer`` then feeds it the whole batch on every rank), and its
        first call checks that every rank of the column holds the same
        tokens (one small all-gather and a host sync), raising
        ``ValueError`` otherwise."""
        self._grid(mesh, tp)
        whole_batch = (mesh is not None and not mesh.local
                       and mesh.shape[M.DATA_AXIS] > 1)
        checked = not whole_batch

        def loss(model, tokens):
            nonlocal checked
            grid = model._grid(mesh, tp)
            if grid is not None and not mesh.local:
                if not checked:
                    _check_whole_batch(tokens, mesh)
                    checked = True
                x = model._group_hidden(tokens[:, :-1], mesh, tp, remat)
                s = x.shape[1]
                r = mesh.axis_index(M.DATA_AXIS)
                y = torch.as_tensor(tokens)[:, 1:][:, r * s:(r + 1) * s]
                part = F.cross_entropy(
                    (x @ model.embed["table"].T).float().flatten(0, 1),
                    y.to(x.device).flatten().long(), reduction="sum")
                total = C.psum(part, mesh.axis_group(M.DATA_AXIS))
                return total / y.shape[0] / (tokens.shape[1] - 1)
            if grid is None:
                logits = model.apply(tokens[:, :-1], remat=remat)
                return F.cross_entropy(logits.float().flatten(0, 1),
                                       tokens[:, 1:].flatten().long())
            xs, tables = model._grid_hidden(tokens[:, :-1], grid, remat)
            targets = tokens[:, 1:].chunk(len(grid), dim=1)
            parts = [F.cross_entropy((x @ t.T).float().flatten(0, 1),
                                     y.to(x.device).flatten().long(),
                                     reduction="sum")
                     for x, t, y in zip(xs, tables, targets)]
            return M.sum_to(parts, model.device) / targets[0].shape[0] / (
                tokens.shape[1] - 1)

        loss.whole_batch = whole_batch
        return loss


def _check_whole_batch(tokens, mesh) -> None:
    """Raise unless every rank of this rank's data column of a process
    group's ``mesh`` holds the same ``tokens``: the ring's sequence blocks
    must be blocks of the same rows."""
    t = torch.as_tensor(tokens).to(mesh.device, torch.int64)
    flat = t.flatten()
    at = torch.arange(1, flat.numel() + 1, device=flat.device)
    mine = torch.stack([torch.tensor(n, device=flat.device)
                        for n in t.shape] + [flat.sum(), (flat * at).sum()])
    seen = C.all_gather(mine[None], mesh.axis_group(M.DATA_AXIS))
    if not bool((seen == seen[0]).all()):
        raise ValueError(
            "loss_fn(mesh=) over a process group's data axis runs its ring "
            "over the sequence, so every rank of a column takes the whole "
            "batch, but the ranks of this column hold different tokens. "
            "Trainer feeds the whole batch to a loss function whose "
            "whole_batch is True; a wrapper must keep that attribute "
            "(functools.update_wrapper)")


def _row_sum(parts, cards, row):
    """The row-parallel sum of a block: over a local mesh's row of
    ``cards`` one copy a card (:func:`~tpudl_torch.mesh.all_sum`), over a
    process group's ``row`` the all-reduce of this rank's one part."""
    if row is None:
        return M.all_sum(parts, cards)
    return [C.reduce_sum(parts[0], row)]


def _same_entry(a, b) -> bool:
    """Whether two process group's meshes put this rank at one entry of
    one grid."""
    return (a.size, a.n_model, a.coords) == (b.size, b.n_model, b.coords)


def _ring_attend(grid):
    """Attention of every entry of ``grid`` (``[row][column]`` lists of q,
    k, v): one causal flash-kernel ring a column, over its rows."""
    def attend(qs, ks, vs):
        rows, cols = len(grid), len(grid[0])
        out = [[None] * cols for _ in range(rows)]
        for j in range(cols):
            col = ring([qs[r][j] for r in range(rows)],
                       [ks[r][j] for r in range(rows)],
                       [vs[r][j] for r in range(rows)],
                       [grid[r][j] for r in range(rows)],
                       causal=True, use_pallas=True)
            for r in range(rows):
                out[r][j] = col[r]
        return out

    return attend


def _cached_attn(layer_cache: dict, pos):
    """Attention for one decode step: write this token's K/V at ``pos``,
    then dense softmax over the cache masked to keys ``<= pos``. ``pos`` is
    a device tensor: 0-d (every row at one position, ``decode_step``) or
    ``[B]`` (a position a row, ``decode_step_slots``)."""
    def attn(q, k_t, v_t):                   # all [B, 1, H, Dh]
        kc, vc = layer_cache["k"], layer_cache["v"]
        keys = torch.arange(kc.shape[1], device=q.device)
        if pos.dim() == 0:
            kc.index_copy_(1, pos.view(1), k_t.to(kc.dtype))
            vc.index_copy_(1, pos.view(1), v_t.to(vc.dtype))
            live = keys <= pos                               # [L]
        else:
            rows = torch.arange(kc.shape[0], device=q.device)
            kc.index_put_((rows, pos), k_t[:, 0].to(kc.dtype))
            vc.index_put_((rows, pos), v_t[:, 0].to(vc.dtype))
            live = (keys[None, :] <= pos[:, None])[:, None, None, :]
        scores = (torch.einsum("bqhd,bshd->bhqs", q, kc)
                  * (1.0 / math.sqrt(q.shape[-1])))
        scores = scores.masked_fill(~live, float("-inf"))
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", w, vc)

    return attn


def _pick(logits, temperature: float, generator):
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
    return logits.argmax(dim=-1).to(torch.int32)


def _param_groups(model: TinyCausalLM) -> dict:
    """tpudl's param group name → the module's ``ParameterDict``."""
    groups = {"embed": model.embed, "final_norm": model.final_norm}
    groups.update({f"block_{i}": p for i, p in enumerate(model.blocks)})
    return groups


def _leaf_groups(model: TinyCausalLM) -> dict:
    """tpudl's param group name → ``{leaf name: whole tensor}`` (split
    leaves of a tensor-parallel layout put back together)."""
    groups = {"embed": dict(model.embed.items()),
              "final_norm": dict(model.final_norm.items())}
    groups.update({f"block_{i}": dict(model._block_leaves(i).items())
                   for i in range(model.layers)})
    return groups


def to_jax_params(model: TinyCausalLM) -> dict:
    """The module's weights as tpudl's param pytree of numpy arrays (host
    copies), whatever the module's layout: the inverse of
    :func:`load_jax_params`."""
    with torch.no_grad():
        return {name: {key: t.detach().cpu().numpy().copy()
                       for key, t in group.items()}
                for name, group in _leaf_groups(model).items()}


def load_jax_params(model: TinyCausalLM, params) -> TinyCausalLM:
    """Copy tpudl's param pytree (``{"embed": {"table"}, "final_norm":
    {...}, "block_<i>": {...}}`` of numpy or jax arrays, whatever their
    shardings) into ``model``, whatever its layout (a split leaf is
    copied slice by slice into its cards). Names and shapes must match
    exactly; returns ``model``."""
    grouped = model._tp_group is not None
    groups = _param_groups(model) if grouped else _leaf_groups(model)
    if set(params) != set(groups):
        raise KeyError(f"param groups {sorted(params)} do not match the "
                       f"model's {sorted(groups)}")
    with torch.no_grad():
        for name, group in groups.items():
            src = params[name]
            if set(src) != set(group):
                raise KeyError(f"{name}: params {sorted(src)} do not match "
                               f"the model's {sorted(group)}")
            for key, whole in group.items():
                arr = np.asarray(src[key])
                shape = list(whole.shape)
                part = grouped and name.startswith("block_") \
                    and key in model._split_names()
                if part:   # this rank's slice of the whole leaf
                    m = model._tp_group.shape[M.MODEL_AXIS]
                    shape[_SHARD_DIM[key]] *= m
                if arr.shape != tuple(shape):
                    raise ValueError(f"{name}.{key}: shape {arr.shape} != "
                                     f"model {tuple(shape)}")
                t = torch.from_numpy(np.ascontiguousarray(arr))
                if part:
                    j = model._tp_group.axis_index(M.MODEL_AXIS)
                    whole.copy_(t.chunk(m, dim=_SHARD_DIM[key])[j])
                    continue
                split = (model._tp_devices is not None
                         and name.startswith("block_")
                         and key in model.tp_shards[0][0])
                if not split:
                    _param_groups(model)[name][key].copy_(t)
                    continue
                i, n = int(name[6:]), len(model._tp_devices)
                for j, part in enumerate(t.chunk(n, dim=_SHARD_DIM[key])):
                    model.tp_shards[j][i][key].copy_(part)
    return model
