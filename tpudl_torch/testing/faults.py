"""Deterministic fault injection: the harness that proves recovery.

Port of ``tpudl/testing/faults.py``. Code exposes named **fault points**
(``faults.fire("frame.dispatch", index=i)``); unarmed, ``fire`` is one
global ``None`` check. A :class:`FaultPlan` is a list of rules, each
naming a point, a deterministic trigger (the Nth call ``at_call``, the
first K calls ``first_calls``, a context match ``when``) and an action:

- ``raise`` — a named builtin exception (default :class:`FaultInjected`);
- ``oom`` — a device OOM shaped as the CUDA caching allocator raises it:
  ``torch.cuda.OutOfMemoryError`` with ``CUDA out of memory. Tried to
  allocate N bytes.``, which the supervisor classifies as ``oom``
  (tpudl raises jaxlib's ``XlaRuntimeError`` with ``RESOURCE_EXHAUSTED``);
- ``sigterm`` — SIGTERM to this process (the preemption kill, at an
  exact step);
- ``corrupt`` / ``unlink`` — flip one byte of, or delete, the file named
  by the firing's ``path`` context;
- ``delay`` — sleep on the firing thread (``slow_client`` wraps it);
- ``burst`` — return ``count`` to the firing site, which submits that
  many extra requests in one serve tick.

Plans arm in-process (``with plan.armed(): ...``) or across a process
boundary through ``TPUDL_FAULT_PLAN`` (JSON; ``install_from_env()`` in
the child). Every triggered fault is appended to ``plan.fired`` and filed
in the flight recorder's error ring (kind ``fault.injected``). The fault
points of the port are tpudl's: ``frame.prepare``, ``frame.h2d``,
``frame.dispatch``, ``frame.d2h``, ``mesh.transfer``, ``shards.read``,
``shards.write``, ``io.read``, ``train.step``, ``compile.precompile``,
``serve.dispatch``, ``serve.tick`` and ``serve.client``.
"""

from __future__ import annotations

import builtins
import json
import os
import signal
import time

from tpudl_torch.testing import tsan as _tsan

__all__ = ["FaultPlan", "FaultInjected", "arm", "disarm", "fire",
           "install_from_env", "oom_error", "PLAN_ENV"]

PLAN_ENV = "TPUDL_FAULT_PLAN"

_PLAN: "FaultPlan | None" = None
_ARM_LOCK = _tsan.named_lock("testing.faults.arm")


# copied from tpudl/testing/faults.py:FaultInjected
class FaultInjected(RuntimeError):
    """Default exception for ``raise`` rules that don't name one."""


def oom_error(nbytes: int = 2 << 30, point: str = "") -> BaseException:
    """One realistic device-OOM exception (the ``oom`` action's payload):
    the type and message shape of the CUDA caching allocator's
    failure."""
    import torch

    suffix = f" [{point}]" if point else ""
    return torch.cuda.OutOfMemoryError(
        f"CUDA out of memory. Tried to allocate {int(nbytes)} bytes."
        f"{suffix}")


# copied from tpudl/testing/faults.py:_resolve_exc
def _resolve_exc(name: str | None):
    """Exception class by builtin name (allowlist: must actually be an
    exception type); anything unknown falls back to FaultInjected so a
    typo'd plan still injects a failure instead of silently passing."""
    if not name:
        return FaultInjected
    cls = getattr(builtins, str(name), None)
    if isinstance(cls, type) and issubclass(cls, BaseException) \
            and not issubclass(cls, (SystemExit, KeyboardInterrupt)):
        return cls
    return FaultInjected


# copied from tpudl/testing/faults.py:_Rule
class _Rule:
    """One deterministic fault rule (see module docstring)."""

    def __init__(self, spec: dict):
        self.point = str(spec["point"])
        self.action = str(spec.get("action", "raise"))
        if self.action not in ("raise", "sigterm", "corrupt", "unlink",
                               "delay", "oom", "burst"):
            raise ValueError(f"unknown fault action {self.action!r}")
        self.seconds = float(spec.get("seconds", 0.0))
        self.nbytes = int(spec.get("bytes", 0) or 0)  # oom: alloc size
        self.count = int(spec.get("count", 0) or 0)   # burst: extra reqs
        # triggers — all optional, all must match when present:
        self.at_call = spec.get("at_call")        # exactly the Nth call
        self.first_calls = spec.get("first_calls")  # calls 1..K
        self.when = dict(spec.get("when") or {})  # ctx equality
        self.exc = spec.get("exc")
        self.message = spec.get("message") or (
            f"injected fault at {self.point}")
        self.calls = 0       # firings seen at this point
        self.triggered = 0   # firings that took the action

    def matches(self, ctx: dict) -> bool:
        if self.at_call is not None and self.calls != int(self.at_call):
            return False
        if self.first_calls is not None \
                and self.calls > int(self.first_calls):
            return False
        for k, v in self.when.items():
            if ctx.get(k) != v:
                return False
        return True

    def to_dict(self) -> dict:
        d = {"point": self.point, "action": self.action}
        for k in ("at_call", "first_calls", "exc", "message"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.seconds:
            d["seconds"] = self.seconds
        if self.nbytes:
            d["bytes"] = self.nbytes
        if self.count:
            d["count"] = self.count
        if self.when:
            d["when"] = self.when
        return d


# copied from tpudl/testing/faults.py:FaultPlan
class FaultPlan:
    """A deterministic set of fault rules, armed process-globally."""

    def __init__(self, rules):
        self._lock = _tsan.named_lock("testing.faults.plan")
        self.rules = [r if isinstance(r, _Rule) else _Rule(dict(r))
                      for r in rules]
        self.fired: list[dict] = []  # every TRIGGERED fault, for asserts

    # -- construction ------------------------------------------------------
    @classmethod
    def kill_at_step(cls, step: int, point: str = "train.step",
                     ) -> "FaultPlan":
        """SIGTERM to this process the time ``point`` fires with
        ``step == N``: the deterministic preemption kill."""
        return cls([{"point": point, "action": "sigterm",
                     "when": {"step": int(step)}}])

    @classmethod
    def raise_in_stage(cls, stage: str, at_call: int = 1,
                       exc: str | None = None) -> "FaultPlan":
        """Raise inside one executor stage (prepare/h2d/dispatch/d2h)
        on its ``at_call``-th entry."""
        return cls([{"point": f"frame.{stage}", "action": "raise",
                     "at_call": int(at_call), "exc": exc}])

    @classmethod
    def transient_io(cls, first_calls: int, point: str = "io.read",
                     exc: str = "OSError") -> "FaultPlan":
        """Fail the first K firings of an IO point, then recover (the
        retry policy's recovery-after-K shape)."""
        return cls([{"point": point, "action": "raise",
                     "first_calls": int(first_calls), "exc": exc,
                     "message": f"injected transient IO error "
                                f"(first {first_calls} calls)"}])

    @classmethod
    def delay(cls, point: str, seconds: float,
              first_calls: int | None = None) -> "FaultPlan":
        """Sleep ``seconds`` at every firing of ``point`` (or only its
        first K), on the firing thread."""
        rule: dict = {"point": point, "action": "delay",
                      "seconds": float(seconds)}
        if first_calls is not None:
            rule["first_calls"] = int(first_calls)
        return cls([rule])

    @classmethod
    def burst(cls, count: int, point: str = "serve.tick",
              at_call: int | None = None) -> "FaultPlan":
        """Inject ``count`` extra requests in one serve tick (every
        firing of ``point``, or only its ``at_call``-th): the firing
        site receives the count and submits that many requests."""
        rule: dict = {"point": point, "action": "burst",
                      "count": int(count)}
        if at_call is not None:
            rule["at_call"] = int(at_call)
        return cls([rule])

    @classmethod
    def slow_client(cls, seconds: float, point: str = "serve.client",
                    first_calls: int | None = None) -> "FaultPlan":
        """A client that stalls ``seconds`` before each submit (or only
        its first K): requests age in the queue."""
        return cls.delay(point, seconds, first_calls=first_calls)

    @classmethod
    def oom(cls, point: str = "frame.dispatch", at_call: int = 1,
            nbytes: int = 2 << 30) -> "FaultPlan":
        """Raise a device OOM (:func:`oom_error`) at one firing of
        ``point``: the supervisor evicts unpinned device-cache entries
        and retries."""
        return cls([{"point": point, "action": "oom",
                     "at_call": int(at_call), "bytes": int(nbytes)}])

    @classmethod
    def corrupt_on_read(cls, point: str = "shards.read",
                        at_call: int = 1) -> "FaultPlan":
        """Bit-flip the file a read point is about to open (the firing
        must pass ``path=`` ctx)."""
        return cls([{"point": point, "action": "corrupt",
                     "at_call": int(at_call)}])

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        raw = os.environ.get(PLAN_ENV)
        if not raw:
            return None
        spec = json.loads(raw)
        if isinstance(spec, dict):
            spec = [spec]
        return cls(spec)

    def to_env(self) -> str:
        """JSON for ``TPUDL_FAULT_PLAN`` (subprocess arming)."""
        return json.dumps([r.to_dict() for r in self.rules])

    # -- the hot hook ------------------------------------------------------
    def fire(self, point: str, **ctx):
        matched = None
        with self._lock:
            for rule in self.rules:
                if rule.point != point:
                    continue
                rule.calls += 1
                if rule.matches(ctx):
                    rule.triggered += 1
                    matched = rule
                    self.fired.append(
                        {"point": point, "action": rule.action,
                         "call": rule.calls, **ctx})
                    break
        if matched is None:
            return
        try:  # forensics: an injected death must leave the same trail
            from tpudl_torch.obs import flight as _flight

            _flight.record_error(
                "fault.injected", matched.message, point=point,
                action=matched.action, call=matched.calls,
                **{k: v for k, v in ctx.items()
                   if isinstance(v, (int, float, str, bool, type(None)))})
        # tpudl: ignore[swallowed-except] — guards the fault
        # breadcrumb; the injected fault below must still fire
        except Exception:
            pass
        if matched.action == "delay":
            # on the FIRING thread deliberately: a delayed dispatch
            # stage blocks its dispatch-window thread exactly like a
            # slow tunnel round-trip would, so overlap tests measure
            # the executor, not the harness
            time.sleep(matched.seconds)
            return None
        if matched.action == "burst":
            # chaos input, not a failure: the COUNT is returned to the
            # firing site (the serve load generator submits that many
            # extra requests in the same tick) so admission control is
            # tested by pressure, not by mocking the queue
            return matched.count
        if matched.action == "oom":
            raise oom_error(matched.nbytes or (2 << 30),
                            point=f"{point} call {matched.calls}")
        if matched.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return  # the handler decides what dies; the firing returns
        if matched.action == "corrupt":
            path = ctx.get("path")
            if path:
                _flip_one_byte(str(path))
            return
        if matched.action == "unlink":
            # the concurrent-eviction race, made deterministic: delete
            # the file between the caller's manifest read and its open
            path = ctx.get("path")
            if path:
                try:
                    os.unlink(str(path))
                except OSError:
                    pass
            return
        raise _resolve_exc(matched.exc)(
            f"{matched.message} [{point} call {matched.calls}]")

    # -- arming ------------------------------------------------------------
    def armed(self):
        return _Armed(self)


# copied from tpudl/testing/faults.py:_Armed
class _Armed:
    def __init__(self, plan: FaultPlan):
        self._plan = plan

    def __enter__(self):
        arm(self._plan)
        return self._plan

    def __exit__(self, *exc):
        disarm()


# copied from tpudl/testing/faults.py:_flip_one_byte
def _flip_one_byte(path: str):
    """In-place single-byte flip at mid-file (deliberately NOT atomic —
    this IS the bit-rot being simulated)."""
    try:
        size = os.path.getsize(path)
        if size == 0:
            return
        at = size // 2
        with open(path, "r+b") as f:
            f.seek(at)
            b = f.read(1)
            f.seek(at)
            f.write(bytes([b[0] ^ 0xFF]))
    except OSError:
        pass


# copied from tpudl/testing/faults.py:arm
def arm(plan: FaultPlan):
    global _PLAN
    with _ARM_LOCK:
        _PLAN = plan
    return plan


# copied from tpudl/testing/faults.py:disarm
def disarm():
    global _PLAN
    with _ARM_LOCK:
        _PLAN = None


# copied from tpudl/testing/faults.py:install_from_env
def install_from_env() -> FaultPlan | None:
    """Arm the ``TPUDL_FAULT_PLAN`` plan, if any (subprocess entry)."""
    plan = FaultPlan.from_env()
    if plan is not None:
        arm(plan)
    return plan


# copied from tpudl/testing/faults.py:fire
def fire(point: str, **ctx):
    """The hook at a fault point: a global ``None`` check unless a plan
    is armed (never add work on this line — it sits on executor and
    train hot paths). Returns the matched rule's payload for
    data-bearing actions (``burst`` → its count), else ``None``."""
    plan = _PLAN
    if plan is not None:
        return plan.fire(point, **ctx)
    return None
