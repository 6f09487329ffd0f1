"""The optax optimizers tpudl trains with, as torch optimizer factories.

Each function takes optax's arguments, with optax's defaults, and returns
a factory ``params -> torch.optim.Optimizer`` that
:class:`~tpudl_torch.train.runner.Trainer` calls on the model's
parameters. The same call means the same update as in tpudl
(``params + optimizer.update(grads, ...)``):

- ``sgd(lr)``: ``p -= lr · g`` (``optax.sgd``: no momentum);
- ``adam(lr, b1, b2, eps)``: ``p -= lr · m̂ / (√v̂ + eps)`` with bias
  correction (``optax.adam``, ``eps_root=0``);
- ``adamw(lr, b1, b2, eps, weight_decay)``: adam's step plus
  ``lr · weight_decay · p``, decoupled, over every parameter
  (``optax.adamw`` with ``mask=None``). optax's decay defaults to 1e-4;
  torch's ``AdamW`` to 1e-2, so the factory passes optax's;
- ``adadelta(lr, rho, eps)`` and ``adamax(lr, b1, b2, eps)``: torch's
  ``Adadelta`` and ``Adamax`` compute optax's ``scale_by_adadelta`` and
  ``scale_by_adamax`` with optax's defaults;
- ``rmsprop(lr, decay, eps)``, ``adagrad(lr, initial_accumulator_value,
  eps)`` and ``nadam(lr, b1, b2, eps)``: torch's versions put ``eps``
  elsewhere or schedule the momentum, so these are optax's
  ``scale_by_rms`` (``eps`` inside the square root), ``scale_by_rss`` and
  ``scale_by_adam(nesterov=True)``, written out here.

Every optimizer keeps its learning rate in ``param_groups[i]["lr"]``, so
it can change between steps without rebuilding the optimizer (optax's
``inject_hyperparams``).
"""

from __future__ import annotations

import functools

import torch

__all__ = ["sgd", "adam", "adamw", "rmsprop", "adagrad", "adadelta", "adamax",
           "nadam"]


def sgd(lr: float):
    """``optax.sgd(lr)`` → a ``torch.optim.SGD`` factory."""
    return functools.partial(torch.optim.SGD, lr=lr)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``optax.adam(lr, b1, b2, eps)`` → a ``torch.optim.Adam`` factory."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(b1, b2),
                             eps=eps)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    """``optax.adamw(lr, b1, b2, eps, weight_decay=1e-4)`` → a
    ``torch.optim.AdamW`` factory with optax's decay."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


def adadelta(lr: float, rho: float = 0.9, eps: float = 1e-6):
    """``optax.adadelta(lr, rho, eps)`` → a ``torch.optim.Adadelta``
    factory."""
    return functools.partial(torch.optim.Adadelta, lr=lr, rho=rho, eps=eps)


def adamax(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``optax.adamax(lr, b1, b2, eps)`` → a ``torch.optim.Adamax``
    factory."""
    return functools.partial(torch.optim.Adamax, lr=lr, betas=(b1, b2),
                             eps=eps)


class _Elementwise(torch.optim.Optimizer):
    """An optax chain ``scale_by_<x>`` then ``scale_by_learning_rate``:
    ``p += -lr · direction(g, state)``, element by element."""

    def direction(self, g, state, group):  # pragma: no cover - abstract
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    u = self.direction(p.grad, self.state[p], group)
                    p.add_(u * -group["lr"])
        return loss


class _RMSprop(_Elementwise):
    def __init__(self, params, lr, decay, eps):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    def direction(self, g, state, group):
        if not state:
            state["nu"] = torch.zeros_like(g)
        nu = state["nu"]
        nu.mul_(group["decay"]).add_(g * g * (1 - group["decay"]))
        return g * torch.rsqrt(nu + group["eps"])


class _Adagrad(_Elementwise):
    def __init__(self, params, lr, initial_accumulator_value, eps):
        super().__init__(params, dict(lr=lr, init=initial_accumulator_value,
                                      eps=eps))

    def direction(self, g, state, group):
        if not state:
            state["sum"] = torch.full_like(g, group["init"])
        s = state["sum"]
        s.add_(g * g)
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                          torch.zeros_like(s))
        return inv * g


class _NAdam(_Elementwise):
    def __init__(self, params, lr, b1, b2, eps):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    def direction(self, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        if not state:
            state["t"] = 0
            state["mu"] = torch.zeros_like(g)
            state["nu"] = torch.zeros_like(g)
        state["t"] += 1
        t, mu, nu = state["t"], state["mu"], state["nu"]
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(g * g * (1 - b2))
        mu_hat = (b1 * (mu / (1 - b1 ** (t + 1)))
                  + (1 - b1) * (g / (1 - b1 ** t)))
        nu_hat = nu / (1 - b2 ** t)
        return mu_hat / (torch.sqrt(nu_hat) + group["eps"])


def rmsprop(lr: float, decay: float = 0.9, eps: float = 1e-8):
    """``optax.rmsprop(lr, decay, eps)``: ``nu = decay·nu + (1-decay)·g²``,
    ``p -= lr · g / √(nu + eps)``."""
    return functools.partial(_RMSprop, lr=lr, decay=decay, eps=eps)


def adagrad(lr: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7):
    """``optax.adagrad(lr, initial_accumulator_value, eps)``: ``s += g²``,
    ``p -= lr · g / √(s + eps)`` (0 where ``s`` is 0)."""
    return functools.partial(_Adagrad, lr=lr,
                             initial_accumulator_value=initial_accumulator_value,
                             eps=eps)


def nadam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``optax.nadam(lr, b1, b2, eps)``: adam with optax's Nesterov
    momentum."""
    return functools.partial(_NAdam, lr=lr, b1=b1, b2=b2, eps=eps)
