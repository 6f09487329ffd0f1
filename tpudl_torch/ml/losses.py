"""Keras-named losses and optimizers, in torch.

Port of ``tpudl/ml/losses.py``: the Keras spellings a sparkdl user
passes as ``kerasLoss`` and ``kerasOptimizer``, bound to torch losses and
to the optimizers of :mod:`tpudl_torch.train.optim`, which compute
optax's updates with optax's defaults (tpudl trains with optax; Keras's
own adam, for one, takes eps 1e-7 where optax takes 1e-8).

Losses take ``(pred, target)`` batches and return the mean scalar; preds
are probabilities (Keras's ``from_logits=False``), clipped to
``[1e-7, 1 - 1e-7]`` before a log, as Keras's backend epsilon does.
"""

from __future__ import annotations

import torch

from tpudl_torch.train import optim

__all__ = ["LOSSES", "OPTIMIZERS", "get_loss", "get_optimizer",
           "get_optimizer_dynamic", "set_learning_rate"]

_EPS = 1e-7  # keras backend epsilon


def _mse(pred, y):
    return torch.mean(torch.square(pred - y))


def _mae(pred, y):
    return torch.mean(torch.abs(pred - y))


def _categorical_crossentropy(pred, y):
    p = torch.clamp(pred, _EPS, 1.0 - _EPS)
    return torch.mean(-torch.sum(y * torch.log(p), dim=-1))


def _sparse_categorical_crossentropy(pred, y):
    p = torch.clamp(pred, _EPS, 1.0 - _EPS)
    picked = torch.take_along_dim(p, y[..., None].long(), dim=-1)
    return torch.mean(-torch.log(picked[..., 0]))


def _binary_crossentropy(pred, y):
    p = torch.clamp(pred, _EPS, 1.0 - _EPS)
    return torch.mean(-(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)))


# copied from tpudl/ml/losses.py:LOSSES (names), in torch
LOSSES = {
    "mse": _mse,
    "mean_squared_error": _mse,
    "mae": _mae,
    "mean_absolute_error": _mae,
    "categorical_crossentropy": _categorical_crossentropy,
    "sparse_categorical_crossentropy": _sparse_categorical_crossentropy,
    "binary_crossentropy": _binary_crossentropy,
}

# copied from tpudl/ml/losses.py:_OPT_DEFAULT_LR (keras default learning
# rates, per optimizer)
_OPT_DEFAULT_LR = {
    "sgd": 0.01,
    "adam": 0.001,
    "rmsprop": 0.001,
    "adagrad": 0.001,
    "adadelta": 0.001,
    "adamax": 0.001,
    "nadam": 0.001,
}

OPTIMIZERS = frozenset(_OPT_DEFAULT_LR)


def get_loss(name: str):
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; one of {sorted(LOSSES)}")
    return LOSSES[name]


def get_optimizer(name: str, learning_rate: float | None = None):
    """A factory ``params -> torch.optim.Optimizer`` for ``name`` at
    ``learning_rate`` (Keras's default for the optimizer if None)."""
    if name not in OPTIMIZERS:
        raise KeyError(
            f"unknown optimizer {name!r}; one of {sorted(OPTIMIZERS)}")
    lr = learning_rate if learning_rate is not None else _OPT_DEFAULT_LR[name]
    return getattr(optim, name)(lr)


def get_optimizer_dynamic(name: str):
    """``(factory, default_lr)``: the optimizer at its default learning
    rate; the rate lives in the optimizer's ``param_groups``, so
    :func:`set_learning_rate` changes it without a rebuild, as optax's
    ``inject_hyperparams`` does for tpudl."""
    factory = get_optimizer(name)
    return factory, _OPT_DEFAULT_LR[name]


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
