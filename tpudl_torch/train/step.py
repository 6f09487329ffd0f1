"""The training step, its mixed-precision wrapper and the eval step.

Port of ``tpudl/train/step.py``. tpudl jit-compiles value-and-grad plus
the optax update into one SPMD program, in which the global-batch mean
makes XLA insert the gradient all-reduce. Here the step is eager torch —
zero the grads, forward, backward, average the gradients over the mesh,
optimizer step — and updates the module in place. Each rank's
``loss_fn`` is the mean over its rows, so the group mean of the
gradients is the gradient of the global-batch mean: the step equals one
rank's step on the global batch. The average is explicit
(:func:`tpudl_torch.mesh.all_reduce_mean` after ``backward``), not
``DistributedDataParallel``: ``loss_fn`` calls ``model.predict`` or
``TinyCausalLM.loss_fn()``, never ``model(...)``, so DDP's reducer would
not see the iteration.

On a local mesh (one process driving its cards) the step is one step
over the whole batch: the model's forward spreads itself over the cards
(``TinyCausalLM.loss_fn(mesh=)``'s ring, ``tp=True``), autograd sums the
gradients of every card's copy of a weight back onto it, and there is no
group to average over. ``param_shardings=`` (tensor parallelism) holds
the model to ``TinyCausalLM.param_shardings``' layout: each split leaf is
a parameter on its own card, and the optimizer steps it there.

Over a process group's ``(data, model)`` grid (one card a rank) the
gradients are reduced over the DATA axis only — this rank's column, the
ranks that hold the same slice of every leaf — and never over its row:

- a leaf split over the model axis is a different slice on each rank of
  the row, and each rank's backward holds its slice's whole gradient;
- a leaf whole on every rank of the row gets equal gradients there,
  because the model's collectives (:mod:`tpudl_torch.collectives`) sum
  what each rank's backward holds of a shared input.

Over the column the gradients are averaged, the gradient of the
global-batch mean whatever the ranks hold. Data parallel (``loss_fn`` the
mean over this rank's rows, ``shard_batch``): each rank's gradient is its
rows' mean's. Sequence parallel (``TinyCausalLM.loss_fn(mesh=)``'s ring:
every rank of the column holds blocks of the same rows, and its loss is
the global loss): the loss's sum over the column is JAX's ``psum``
(:func:`tpudl_torch.collectives.psum`), whose backward sums the ranks'
seeds, so each rank's gradient is ``n`` times its blocks' share, and the
mean is the sum of the shares. Either way the update is the one-card
update on the same global batch.
"""

from __future__ import annotations

import contextlib
import functools
import itertools

import torch

from tpudl_torch import mesh as M
from tpudl_torch.device import full_f32

__all__ = ["make_train_step", "make_eval_step", "with_compute_dtype"]


class _Bound(torch.nn.Module):
    """``loss_fn`` bound to ``model`` as a module's forward, so that
    :func:`torch.func.functional_call` can swap the model's tensors for
    the call."""

    def __init__(self, loss_fn, model):
        super().__init__()
        self.loss_fn = loss_fn
        self.model = model

    def forward(self, *batch):
        return self.loss_fn(self.model, *batch)


def with_compute_dtype(loss_fn, dtype: torch.dtype):
    """Mixed precision: float32 MASTER weights, ``dtype`` (bfloat16)
    compute. Wraps ``loss_fn(model, *batch)`` so that every float32
    parameter and buffer of ``model`` is cast to ``dtype`` for the
    forward and backward while the optimizer updates the f32 originals.

    The cast is inside the autograd graph (``.to(dtype)`` of each
    parameter, swapped in for the call with
    :func:`torch.func.functional_call`), so the gradients land on the
    masters in f32 — tpudl's tree cast. Not ``torch.autocast``, whose
    per-op policy keeps softmax, log and reductions in f32 and gives
    other numbers; not a bf16 copy of the module, which would cut the
    gradients off from the masters. Training the masters in bf16 instead
    stalls once SGD updates drop below bf16's ULP
    (``bf16(1.0 + 1e-6) == 1.0``)."""
    def wrapped(model, *batch):
        # a named span, so that a profile can attribute the casts
        with torch.profiler.record_function("train.compute_dtype_cast"):
            cast = {f"model.{name}": t.to(dtype)
                    for name, t in itertools.chain(model.named_parameters(),
                                                   model.named_buffers())
                    if t.dtype == torch.float32}
        return torch.func.functional_call(_Bound(loss_fn, model), cast,
                                          batch)

    return functools.update_wrapper(wrapped, loss_fn)


def make_train_step(loss_fn, *, mesh: M.Mesh | None = None,
                    param_shardings=None):
    """Build ``step(model, optimizer, *batch) -> loss``. ``loss_fn(model,
    *batch)`` returns the batch-mean scalar loss; ``optimizer`` is a
    ``torch.optim`` optimizer over the model's parameters. With a
    ``mesh`` (:func:`tpudl_torch.mesh.build_mesh`), ``batch`` is this
    rank's rows (the whole batch for a loss whose ``whole_batch`` is
    True, a ring) and the gradients are averaged over the group's data
    axis before the update (see the module docstring); on a local mesh
    the batch is the whole batch and nothing is averaged. The returned
    loss is this rank's, a detached device tensor:
    the step forces no host sync. A model with float32 masters steps in
    full f32 whatever TF32 setting the process holds
    (:func:`tpudl_torch.device.full_f32`), as tpudl's step computes; that
    holds under :func:`with_compute_dtype` too, where it touches only the
    f32 ops.

    ``param_shardings`` (a ``TinyCausalLM.param_shardings(mesh)`` pytree)
    lays the model out so at its first step (``shard_params``) and
    checks that ``optimizer`` holds the laid-out parameters: build the
    optimizer after ``model.shard_params(mesh)``."""
    layout = _layout_mesh(param_shardings)

    def step(model, optimizer, *batch):
        if layout is not None:
            model.shard_params(layout)
            held = {id(p) for g in optimizer.param_groups
                    for p in g["params"]}
            if any(id(p) not in held for p in model.parameters()):
                raise ValueError(
                    "the optimizer does not hold the model's parameters as "
                    "param_shardings lays them out; build it after "
                    "model.shard_params(mesh)")
        f32 = next(model.parameters()).dtype == torch.float32
        with full_f32() if f32 else contextlib.nullcontext():
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model, *batch)
            loss.backward()
            if mesh is not None and not mesh.local:
                M.all_reduce_mean([p.grad for p in model.parameters()
                                   if p.grad is not None], mesh, M.DATA_AXIS)
            optimizer.step()
        return loss.detach()

    return step


def _layout_mesh(param_shardings):
    """The mesh of a ``param_shardings`` pytree (its first
    :class:`~tpudl_torch.mesh.NamedSharding`), or None."""
    if param_shardings is None:
        return None
    stack = [param_shardings]
    while stack:
        node = stack.pop()
        if isinstance(node, M.NamedSharding):
            return node.mesh
        if isinstance(node, dict):
            stack.extend(node.values())
    raise ValueError("param_shardings holds no NamedSharding "
                     "(TinyCausalLM.param_shardings(mesh) gives the layout)")


def make_eval_step(apply_fn, *, mesh: M.Mesh | None = None):
    """Build ``eval(model, *batch) -> outputs``: ``apply_fn(model,
    *batch)`` without autograd (for validation passes between epochs).
    With a ``mesh``, every rank evaluates the whole batch on its device,
    so every rank gets tpudl's replicated result; host arrays in
    ``batch`` go to the model's device. Float32 masters evaluate in full
    f32, as the train step."""
    def step(model, *batch):
        first = next(model.parameters())
        device = mesh.device if mesh is not None else first.device
        batch = tuple(torch.as_tensor(b).to(device) for b in batch)
        f32 = first.dtype == torch.float32
        with torch.no_grad(), \
                full_f32() if f32 else contextlib.nullcontext():
            return apply_fn(model, *batch)

    return step
