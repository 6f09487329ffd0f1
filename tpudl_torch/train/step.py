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

``param_shardings=`` (tensor parallelism) is refused (ROADMAP Queue 1,
'LM parallelism').
"""

from __future__ import annotations

import contextlib
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

    return wrapped


def make_train_step(loss_fn, *, mesh: M.Mesh | None = None,
                    param_shardings=None):
    """Build ``step(model, optimizer, *batch) -> loss``. ``loss_fn(model,
    *batch)`` returns the batch-mean scalar loss; ``optimizer`` is a
    ``torch.optim`` optimizer over the model's parameters. With a
    ``mesh`` (:func:`tpudl_torch.mesh.build_mesh`), ``batch`` is this
    rank's rows and the gradients are averaged over the group before the
    update. The returned loss is this rank's, a detached device tensor:
    the step forces no host sync. A model with float32 masters steps in
    full f32 whatever TF32 setting the process holds
    (:func:`tpudl_torch.device.full_f32`), as tpudl's step computes; that
    holds under :func:`with_compute_dtype` too, where it touches only the
    f32 ops."""
    if param_shardings is not None:
        raise NotImplementedError(
            "make_train_step(param_shardings=...) (tensor parallelism) is "
            "not ported to tpudl_torch yet (ROADMAP Queue 1, "
            "'LM parallelism')")

    def step(model, optimizer, *batch):
        f32 = next(model.parameters()).dtype == torch.float32
        with full_f32() if f32 else contextlib.nullcontext():
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model, *batch)
            loss.backward()
            if mesh is not None:
                M.all_reduce_mean([p.grad for p in model.parameters()
                                   if p.grad is not None], mesh)
            optimizer.step()
        return loss.detach()

    return step


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
