"""The job the preemption tests run in a child process: ``TinyCausalLM``
at the tests' width trained by ``JobRuntime.run_fit`` under adamw, with a
checkpoint every 4 steps, from ``init(0)``.

This file imports only torch, numpy and ``tpudl_torch``: a child runs it
as a script (``python tests/torch_jobs_fns.py <workdir> <out> [lr]``) and
must not pull in jax or tpudl. It arms ``TPUDL_FAULT_PLAN`` (a
``kill_at_step`` rule SIGTERMs it), exits 75 when preempted, and on
completion writes the final ``state_dict`` and the losses to
``<out>.npz``. The parent builds the same job in-process from
:func:`job` for the uninterrupted reference."""

import os
import sys

import numpy as np
import torch

ARCH = dict(vocab=64, dim=32, heads=2, layers=2, max_len=64)
STEPS, SAVE_EVERY, LR = 12, 4, 3e-4
MATERIAL = {"model": "TinyCausalLM:v64:d32:h2:l2", "data": "seed100"}


def batch(step: int) -> np.ndarray:
    """The step's tokens, stateless in ``step`` (the Trainer contract)."""
    return np.random.default_rng(100 + step).integers(
        0, ARCH["vocab"], size=(2, 17)).astype(np.int32)


def model(params=None):
    from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

    lm = TinyCausalLM(device="cpu", **ARCH)
    load_jax_params(lm, params if params is not None else lm.init(0))
    return lm


def job(workdir: str, lr: float = LR, install_signals: bool = True,
        **spec_kw):
    """``(runtime, trainer, model)`` of the job in ``workdir``."""
    from tpudl_torch.jobs import JobRuntime, JobSpec
    from tpudl_torch.train import Trainer, adamw

    lm = model()
    spec = JobSpec("fit", workdir, material={**MATERIAL, "lr": lr},
                   save_every=SAVE_EVERY, **spec_kw)
    trainer = Trainer(lm.loss_fn(), adamw(lr), log_every=1)
    return JobRuntime(spec, install_signals=install_signals), trainer, lm


def main(argv) -> int:
    from tpudl_torch.testing import faults

    torch.set_num_threads(1)
    faults.install_from_env()
    workdir, out = argv[0], argv[1]
    lr = float(argv[2]) if len(argv) > 2 else LR
    rt, trainer, lm = job(workdir, lr)
    _, _, hist = rt.run_fit(trainer, lm, batch, STEPS, exit_on_preempt=True)
    np.savez(out, losses=np.asarray([h["loss"] for h in hist]),
             steps=np.asarray([h["step"] for h in hist]),
             **{f"p.{k}": v.detach().numpy()
                for k, v in lm.state_dict().items()})
    print("DONE", os.getpid())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
