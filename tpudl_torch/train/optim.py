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
  torch's ``AdamW`` to 1e-2, so the factory passes optax's.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["sgd", "adam", "adamw"]


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
