"""Numerical-debug hooks: the port of ``tpudl/debug.py``.

tpudl turns on ``jax_debug_nans`` for NaN provenance and wraps a
function in ``checkify`` for value checks inside a jitted program. The
port's counterparts run under a :class:`torch.overrides.TorchFunctionMode`,
which sees every torch operation the Python code calls:

- :func:`debug_nans` raises ``FloatingPointError`` at the first operation
  whose floating output holds a NaN, naming the operation and the
  innermost ``nn.Module`` (and source line) it ran in; it also turns on
  ``torch.autograd.set_detect_anomaly(True, check_nan=True)``, so a NaN
  in the backward raises too. A debugging tool: every check synchronizes
  with the card, and anomaly mode slows every backward. Both are
  restored when the block exits.
- :func:`checkify_fn` records errors in a tensor on the function's
  device without synchronizing inside the function, so the wrapped
  function can be captured as a CUDA graph, and raises a typed error
  (:class:`NaNError`, :class:`DivisionByZeroError`, :class:`OOBError`,
  jax's names and messages) for the first error after the call. An
  out-of-range index is recorded and clamped into range before the
  operation runs, so no device-side assert fires and the CUDA context
  stays usable.

Host-side input checking lives in ``Frame.map_batches(check_finite=True)``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["debug_nans", "checkify_fn", "CheckifyError", "NaNError",
           "DivisionByZeroError", "OOBError"]

F = torch.nn.functional

# torch's own frames, and this module's, are never an op's source line
_SKIP_FILES = (os.path.dirname(torch.__file__), __file__)


def _op_name(func) -> str:
    return getattr(func, "__name__", None) or repr(func)


# factories whose output is uninitialized memory: a NaN bit pattern there
# is garbage the caller overwrites (a kernel's output buffer), not a value
_UNINITIALIZED = {torch.empty, torch.empty_like, torch.empty_strided,
                  torch.Tensor.new_empty, torch.Tensor.new_empty_strided}


def _float_outputs(out, func=None) -> list:
    if func in _UNINITIALIZED:
        return []
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [o for o in outs if isinstance(o, torch.Tensor)
            and (o.is_floating_point() or o.is_complex())]


def _source_line() -> str | None:
    """The innermost frame outside torch and this module: the line of
    the user's (or the port's) code that called the operation."""
    frame = sys._getframe(1)
    while frame is not None:
        f = frame.f_code.co_filename
        if not f.startswith(_SKIP_FILES):
            return f"{f}:{frame.f_lineno} in {frame.f_code.co_name}"
        frame = frame.f_back
    return None


class _ModuleStack(threading.local):
    def __init__(self):
        self.stack: list = []


_MODULES = _ModuleStack()


def _pre_hook(module, args):
    _MODULES.stack.append(type(module).__qualname__)


def _post_hook(module, args, output):
    if _MODULES.stack:
        _MODULES.stack.pop()


class _NanMode(TorchFunctionMode):
    """Raise at the first operation whose floating output holds a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            return out          # a capture cannot read a value back
        for t in _float_outputs(out, func):
            if bool(torch.isnan(t).any()):
                module = _MODULES.stack[-1] if _MODULES.stack else None
                line = _source_line()
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {_op_name(func)}"
                    + (f" inside module {module}" if module else "")
                    + (f" at {line}" if line else ""))
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the block, the first torch operation that produces a NaN
    raises ``FloatingPointError`` naming the operation and the innermost
    module it ran in; the backward runs under autograd's anomaly mode
    with its NaN check. Everything is restored on exit. With
    ``enable=False`` the block runs unchecked."""
    if not enable:
        yield
        return
    from torch.nn.modules import module as _module

    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    pre = _module.register_module_forward_pre_hook(_pre_hook)
    post = _module.register_module_forward_hook(_post_hook)
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        with _NanMode():
            yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)
        pre.remove()
        post.remove()
        _MODULES.stack.clear()


# -- checkify -----------------------------------------------------------------

class CheckifyError(RuntimeError):
    """The first error a :func:`checkify_fn` call recorded."""


class NaNError(CheckifyError):
    pass


class DivisionByZeroError(CheckifyError):
    pass


class OOBError(CheckifyError):
    pass


_DIVS = {torch.div, torch.Tensor.div}
_FLOOR_DIVISIONS = {torch.floor_divide, torch.Tensor.floor_divide,
                    torch.Tensor.__floordiv__, torch.Tensor.__rfloordiv__}
_REMAINDERS = {torch.remainder, torch.fmod, torch.Tensor.remainder,
               torch.Tensor.fmod, torch.Tensor.__mod__,
               torch.Tensor.__rmod__}
_REVERSED = {torch.Tensor.__rfloordiv__, torch.Tensor.__rmod__}


def _is_int(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex())
    return isinstance(x, int) and not isinstance(x, bool)


class _CheckMode(TorchFunctionMode):
    """One call's checks: each check is device operations that fold its
    condition into the owner's error code and payload; nothing reads a
    value back."""

    def __init__(self, owner):
        super().__init__()
        self.owner = owner
        self.seen = 0

    def _site(self, kind: str, message: str) -> int:
        """The error code of this call's next check (stable across calls
        that run the same operations: a replay reads the codes its
        capture assigned)."""
        self.seen += 1
        return self.owner._code(self.seen, kind, message)

    def _flag(self, cond, code: int, payload=None):
        o = self.owner
        hit = (o.error == 0) & cond.reshape(())
        if payload is not None:
            o.payload.copy_(torch.where(hit, payload, o.payload))
        o.error.copy_(torch.where(hit, torch.full_like(o.error, code),
                                  o.error))

    def _index(self, func, idx, size: int, axis: int, shape, lo: int):
        """``idx`` checked against ``[lo, size)`` and clamped into it."""
        bad = (idx < lo) | (idx >= size)
        flat = bad.reshape(-1)
        if flat.numel():
            # index_select, not x[t]: a 0-dim index tensor would be read
            # back to the host as an int, which a capture cannot do
            first = torch.argmax(flat.to(torch.int32)).reshape(1)
            value = idx.reshape(-1).index_select(0, first).reshape(())
        else:
            value = torch.zeros((), dtype=torch.int64, device=idx.device)
        # fills, not host copies: the check must stay capturable
        const = lambda v: torch.full((), v, dtype=torch.int64,  # noqa: E731
                                     device=idx.device)
        payload = torch.stack([value.to(torch.int64), const(axis),
                               const(size)])
        code = self._site("oob", f"{_op_name(func)}|{tuple(shape)}")
        self._flag(bad.any() if flat.numel() else
                   torch.zeros((), dtype=torch.bool, device=idx.device),
                   code, payload)
        return idx.clamp(lo, size - 1)

    def _checked_args(self, func, args, kwargs):
        o = self.owner
        args = list(args)
        if o.oob:
            if func in (F.embedding,) and len(args) >= 2:
                args[0] = self._index(func, args[0], args[1].shape[0], 0,
                                      args[1].shape, 0)
            elif func is torch.embedding and len(args) >= 2:
                args[1] = self._index(func, args[1], args[0].shape[0], 0,
                                      args[0].shape, 0)
            elif func in (torch.index_select, torch.Tensor.index_select) \
                    and len(args) >= 3:
                x, dim = args[0], args[1] % args[0].dim()
                args[2] = self._index(func, args[2], x.shape[dim], dim,
                                      x.shape, 0)
            elif func in (torch.gather, torch.Tensor.gather) and \
                    len(args) >= 3:
                x, dim = args[0], args[1] % args[0].dim()
                args[2] = self._index(func, args[2], x.shape[dim], dim,
                                      x.shape, 0)
            elif func is torch.Tensor.__getitem__ and len(args) == 2:
                args[1] = self._getitem_index(func, args[0], args[1])
        if o.div and self._integer_division(func, args, kwargs):
            k = 0 if func in _REVERSED else 1
            code = self._site("div", _op_name(func))
            y = args[k]
            if isinstance(y, torch.Tensor):
                self._flag((y == 0).any(), code)
                # keep the division defined: the op sees 1 for 0
                args[k] = torch.where(y == 0, torch.ones_like(y), y)
            elif y == 0:
                self._flag(torch.ones((), dtype=torch.bool,
                                      device=o.error.device), code)
                args[k] = 1
        return args, kwargs

    @staticmethod
    def _integer_division(func, args, kwargs) -> bool:
        """An integer division or remainder: both operands integers and
        the result an integer (``//``, ``div`` with a rounding mode,
        ``%``, ``fmod``), as jax's ``div_checks`` check ``lax.div``.
        ``/`` on integers divides in floating point, which is defined."""
        if len(args) < 2 or not all(_is_int(a) for a in args[:2]):
            return False
        if func in _FLOOR_DIVISIONS or func in _REMAINDERS:
            return True
        return func in _DIVS and kwargs.get("rounding_mode") in ("trunc",
                                                                 "floor")

    def _getitem_index(self, func, x, index):
        """Integer-tensor indices of ``x[index]`` checked against numpy's
        range ``[-n, n)`` of their axes, up to the first ``None`` or
        ``...`` (after which axes are not counted)."""
        parts = list(index) if isinstance(index, tuple) else [index]
        for axis, p in enumerate(parts):
            if p is None or p is Ellipsis or axis >= x.dim():
                break
            if isinstance(p, torch.Tensor) and _is_int(p) and \
                    p.dtype != torch.bool:
                n = x.shape[axis]
                parts[axis] = self._index(func, p, n, axis, x.shape, -n)
        return tuple(parts) if isinstance(index, tuple) else parts[0]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        args, kwargs = self._checked_args(func, args, kwargs)
        out = func(*args, **kwargs)
        if self.owner.nan:
            floats = _float_outputs(out, func)
            if floats:
                code = self._site("nan", _op_name(func))
                cond = torch.stack([torch.isnan(t).any() for t in floats]
                                   ).any()
                self._flag(cond, code)
        return out


class _Checked:
    """The wrapper :func:`checkify_fn` returns."""

    def __init__(self, fn, nan: bool, div: bool, oob: bool):
        self.fn = fn
        self.__wrapped__ = fn
        self.nan, self.div, self.oob = bool(nan), bool(div), bool(oob)
        self.error = None     # int64 [] on the device: 0, or a check's code
        self.payload = None   # int64 [3]: an OOB error's index, axis, size
        self._codes: dict = {}    # (n-th check of a call) -> code
        self._messages: dict = {}  # code -> (kind, message)

    def _code(self, n: int, kind: str, message: str) -> int:
        key = (n, kind, message)
        code = self._codes.get(key)
        if code is None:
            code = self._codes[key] = len(self._codes) + 1
            self._messages[code] = (kind, message)
        return code

    def _buffers(self, args):
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   torch.device("cpu"))
        if self.error is None or self.error.device != dev:
            self.error = torch.zeros((), dtype=torch.int64, device=dev)
            self.payload = torch.zeros(3, dtype=torch.int64, device=dev)

    def __call__(self, *args, **kwargs):
        self._buffers(args)
        self.error.zero_()
        self.payload.zero_()
        with _CheckMode(self):
            out = self.fn(*args, **kwargs)
        if not (self.error.is_cuda and
                torch.cuda.is_current_stream_capturing()):
            self.check()
        return out

    def check(self) -> None:
        """Raise the first error the last call (or graph replay) recorded:
        one synchronizing read of the error code."""
        if self.error is None:
            return
        code = int(self.error.item())
        if not code:
            return
        kind, message = self._messages[code]
        if kind == "nan":
            raise NaNError(f"nan generated by primitive: {message}.")
        if kind == "div":
            raise DivisionByZeroError(f"division by zero (in {message})")
        op, shape = message.split("|", 1)
        index, axis, size = (int(v) for v in self.payload.tolist())
        raise OOBError(f"out-of-bounds indexing for array of shape "
                       f"{shape}: index {index} is out of bounds for axis "
                       f"{axis} with size {size}. (in {op})")


def checkify_fn(fn, *, nan: bool = True, div: bool = True,
                oob: bool = True):
    """Wrap ``fn`` with value checks — a NaN produced by an operation
    (``nan``), an integer division or remainder by zero (``div``), an
    out-of-range index of ``F.embedding``/``index_select``/
    ``gather``/``x[idx]`` (``oob``) — recorded on ``fn``'s device without
    a synchronize. After an eager call the wrapper raises the first
    error (:class:`NaNError`, :class:`DivisionByZeroError` or
    :class:`OOBError`). Called inside a CUDA-graph capture it raises
    nothing; after each replay of that graph, ``wrapper.check()`` raises
    what the replay recorded. An out-of-range index is clamped into range
    before its operation runs."""
    return _Checked(fn, nan, div, oob)
