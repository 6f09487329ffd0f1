"""The old spelling of the kernel-build cache's switch, as tpudl keeps
``tpudl/compilation_cache.py``: the cache grew into the
:mod:`tpudl_torch.compile` subsystem. Import from
``tpudl_torch.compile``; this module keeps the original spelling
working."""

from __future__ import annotations

from tpudl_torch.compile import enable_compilation_cache

__all__ = ["enable_compilation_cache"]
