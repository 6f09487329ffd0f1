"""Test-support machinery that ships with the port.

:mod:`tpudl_torch.testing.faults` is the deterministic fault-injection
harness (tpudl's ``tpudl.testing.faults``): code exposes named fault
points (``faults.fire("...")``, a no-op unless a plan is armed), and a
:class:`~tpudl_torch.testing.faults.FaultPlan` decides which firing
fails and how. It lives in the package, not in ``tests/``, because a
preemption test arms its plan in a subprocess through
``TPUDL_FAULT_PLAN``.
"""

from tpudl_torch.testing.faults import FaultPlan, arm, disarm, fire  # noqa: F401
