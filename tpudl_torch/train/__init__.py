"""Training for the port: HorovodRunner and its context, the step, the
loop, checkpoints and the optax optimizers.

Port of ``tpudl/train`` (``HorovodRunner``, ``TrainContext``,
``Trainer``, ``CheckpointManager``, ``Preempted``, ``RestartsExhausted``,
``make_train_step``, ``make_eval_step``, ``with_compute_dtype``) with data
parallelism over ``torch.distributed``, and of the optax optimizers tpudl
uses.
"""

from tpudl_torch.train.checkpoint import CheckpointManager
from tpudl_torch.train.optim import (adadelta, adagrad, adam, adamax, adamw,
                                     nadam, rmsprop, sgd)
from tpudl_torch.train.runner import (HorovodRunner, Preempted,
                                      RestartsExhausted, TrainContext,
                                      Trainer)
from tpudl_torch.train.step import (make_eval_step, make_train_step,
                                    with_compute_dtype)

__all__ = ["HorovodRunner", "TrainContext", "Trainer", "CheckpointManager",
           "Preempted", "RestartsExhausted", "make_train_step",
           "make_eval_step", "with_compute_dtype", "sgd", "adam", "adamw",
           "rmsprop", "adagrad", "adadelta", "adamax", "nadam"]
