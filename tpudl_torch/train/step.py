"""The training step.

Port of ``tpudl/train/step.py`` ``make_train_step`` on one device: tpudl
jit-compiles value-and-grad plus the optax update into one SPMD program;
here the step is eager torch — zero the grads, forward, backward,
optimizer step — and updates the module in place. ``mesh=`` and
``param_shardings=`` (data and tensor parallelism) are not ported yet and
raise; ``with_compute_dtype`` and ``make_eval_step`` are not ported yet
(ROADMAP Queue 1, 'Training, rest').
"""

from __future__ import annotations

__all__ = ["make_train_step"]


def make_train_step(loss_fn, *, mesh=None, param_shardings=None):
    """Build ``step(model, optimizer, *batch) -> loss``. ``loss_fn(model,
    *batch)`` returns the batch-mean scalar loss (for example
    ``TinyCausalLM.loss_fn()``); ``optimizer`` is a ``torch.optim``
    optimizer over the model's parameters. The returned loss is a
    detached device tensor: the step forces no host sync."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...) (data parallelism) is not ported to "
            "tpudl_torch yet (ROADMAP Queue 1, 'Training, rest')")
    if param_shardings is not None:
        raise NotImplementedError(
            "make_train_step(param_shardings=...) (tensor parallelism) is "
            "not ported to tpudl_torch yet (ROADMAP Queue 1, "
            "'LM parallelism')")

    def step(model, optimizer, *batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
