"""Shape-bucket ladders: snap ragged batch/sequence lengths to O(log n)
rungs.

Copied from ``tpudl/compile/buckets.py`` (``BucketLadder``,
``resolve_ladder``, ``pad_to``, ``count_pad_rows``; host logic). In the
port the rungs fix the padded sequence width of a packed text batch, the
padded prompt of a generate call (one CUDA graph a rung under the program
store) and, under ``Frame.map_batches(buckets=)``, the padded row count of
a ragged batch, exactly as in tpudl, so both packages run the same shapes.
The ladder specs mean the same as there, passed by the caller or, for
``resolve_ladder(None)``, read from ``TPUDL_COMPILE_BUCKETS`` (unset: no
bucketing):

- ``pow2ish`` (also ``1``/``auto``): powers of two plus the 3·2^k
  midpoints — 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, …;
- ``pow2``: pure powers of two;
- an explicit comma list (``"8,16,32,64"``): sizes past the top rung stay
  exact;
- ``0`` / ``off`` / ``None``: no bucketing.
"""

from __future__ import annotations

import math
import os

import numpy as np

__all__ = ["BucketLadder", "resolve_ladder", "DEFAULT_SPEC", "pad_to",
           "count_pad_rows"]

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

    def is_rung(self, n: int) -> bool:
        return int(n) > 0 and self.pick(int(n)) == int(n)

    def rungs_up_to(self, n: int) -> list[int]:
        """Every distinct rung the ladder can emit for sizes 1..n."""
        out, seen = [], set()
        for i in range(1, int(n) + 1):
            r = self.pick(i)
            if r not in seen:
                seen.add(r)
                out.append(r)
        return out

    def to_meta(self) -> dict:
        """JSON identity (the program manifest records it)."""
        return {"spec": self.spec,
                "rungs": list(self.rungs) if self.rungs else None}

    def __repr__(self):
        return f"BucketLadder({self.spec!r})"


# copied from tpudl/compile/buckets.py:resolve_ladder
def resolve_ladder(value=None) -> BucketLadder | None:
    """The one resolution rule: an explicit value beats the
    ``TPUDL_COMPILE_BUCKETS`` env, and ``None`` means *consult the env*
    (unset env = bucketing off). Accepts a :class:`BucketLadder`, a spec
    string, ``True`` (the default ladder) or ``False``/``"off"``."""
    if isinstance(value, BucketLadder):
        return value
    if value is None:
        value = os.environ.get("TPUDL_COMPILE_BUCKETS", "")
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
            f"TPUDL_COMPILE_BUCKETS={value!r} is neither a known ladder "
            f"spec (pow2, pow2ish, 1, off) nor a comma list of rungs")
    return BucketLadder(rungs=rungs)


def pad_to(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading dim up to ``target`` rows by repeating row 0 (zeros
    for an empty batch); the executor strips the pad rows from the
    outputs, so real rows are untouched."""
    n = int(arr.shape[0])
    if n >= int(target):
        return arr
    pad = np.repeat(
        arr[:1] if n else np.zeros_like(arr, shape=(1, *arr.shape[1:])),
        int(target) - n, axis=0)
    return np.concatenate([arr, pad], axis=0)


def count_pad_rows(n: int) -> None:
    """Publish bucket padding into the process registry
    (``compile.bucket_pad_rows``)."""
    from tpudl_torch.obs import metrics as _m

    _m.counter("compile.bucket_pad_rows").inc(int(n))
