"""Shape-bucket ladders: snap ragged batch/sequence lengths to O(log n)
rungs.

Copied from ``tpudl/compile/buckets.py`` (``BucketLadder``,
``resolve_ladder``; host logic). In the port the rungs fix the padded
sequence width of a packed text batch and the KV-cache length of a
generate call, exactly as in tpudl, so both packages run the same shapes.
The ladder specs mean the same as there; the port reads no environment
variable, so a spec is always passed by the caller:

- ``pow2ish`` (also ``1``/``auto``): powers of two plus the 3·2^k
  midpoints — 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, …;
- ``pow2``: pure powers of two;
- an explicit comma list (``"8,16,32,64"``): sizes past the top rung stay
  exact;
- ``0`` / ``off`` / ``None``: no bucketing.
"""

from __future__ import annotations

import math

__all__ = ["BucketLadder", "resolve_ladder", "DEFAULT_SPEC"]

DEFAULT_SPEC = "pow2ish"

_OFF = ("", "0", "off", "none", "false")


class BucketLadder:
    """One bucket ladder: ``pick(n)`` → the padded size for ``n``.
    Generated specs (``pow2ish``/``pow2``) are closed-form and unbounded;
    explicit rung lists return ``n`` itself past their top rung."""

    def __init__(self, spec: str = DEFAULT_SPEC, rungs=None):
        if rungs is not None:
            rungs = sorted({int(r) for r in rungs})
            if not rungs or rungs[0] < 1:
                raise ValueError(f"bucket rungs must be >= 1: {rungs}")
            self.spec = ",".join(str(r) for r in rungs)
            self.rungs: tuple[int, ...] | None = tuple(rungs)
            return
        if spec not in ("pow2", "pow2ish"):
            raise ValueError(
                f"unknown bucket-ladder spec {spec!r} (want 'pow2', "
                f"'pow2ish', or an explicit comma list)")
        self.spec = spec
        self.rungs = None

    def pick(self, n: int) -> int:
        """Smallest rung ≥ ``n`` (``n`` itself past an explicit ladder's
        top rung; ``n <= 0`` is returned unchanged)."""
        n = int(n)
        if n <= 0:
            return n
        if self.rungs is not None:
            for r in self.rungs:
                if r >= n:
                    return r
            return n
        p = 1 << max(0, math.ceil(math.log2(n)))
        if self.spec == "pow2ish" and p >= 4 and n <= (3 * p) // 4:
            return (3 * p) // 4
        return p

    def __repr__(self):
        return f"BucketLadder({self.spec!r})"


def resolve_ladder(value=None) -> BucketLadder | None:
    """A :class:`BucketLadder` from a ladder, a spec string or ``True``
    (the default ladder); ``None``, ``False`` and ``"off"`` mean no
    bucketing."""
    if isinstance(value, BucketLadder):
        return value
    if value is None:
        return None
    if value is True:
        return BucketLadder(DEFAULT_SPEC)
    if value is False:
        return None
    spec = str(value).strip().lower()
    if spec in _OFF:
        return None
    if spec in ("1", "auto", "default", "pow2ish"):
        return BucketLadder("pow2ish")
    if spec == "pow2":
        return BucketLadder("pow2")
    try:
        rungs = [int(s) for s in spec.split(",") if s.strip()]
    except ValueError:
        raise ValueError(
            f"bucket spec {value!r} is neither a known ladder (pow2, "
            f"pow2ish, 1, off) nor a comma list of rungs")
    return BucketLadder(rungs=rungs)

