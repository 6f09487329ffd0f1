"""Training for the port: the step, the loop, the optax optimizers.

Port of the one-device subset of ``tpudl/train`` (``make_train_step``,
``Trainer``, ``Preempted``) and of the optax optimizers tpudl uses.
"""

from tpudl_torch.train.optim import adam, adamw, sgd
from tpudl_torch.train.runner import Preempted, Trainer
from tpudl_torch.train.step import make_train_step

__all__ = ["Trainer", "Preempted", "make_train_step", "sgd", "adam",
           "adamw"]
