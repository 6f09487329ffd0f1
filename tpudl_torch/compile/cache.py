"""The persistent tier of the port's compile subsystem: the kernel-build
cache.

tpudl's bottom tier is JAX's persistent XLA compilation cache. The port's
counterpart of an XLA binary is a kernel library: each
``tpudl_torch/csrc/<name>.cu`` built by ``nvcc`` into
``<name>-<digest>.so`` (:mod:`tpudl_torch._build`), which costs seconds a
source on every process that finds no library to load. This module
decides where those libraries live, with tpudl's knob and precedence:

- ``TPUDL_COMPILE_CACHE_DIR=0`` turns the cache off, even against an
  explicit path: each process builds into a temporary directory of its
  own (and pays ``nvcc``);
- else an explicit ``enable_compilation_cache(path)`` beats the env,
  which beats the default. A named directory holds the libraries under
  ``<dir>/kernels``; the default is :data:`DEFAULT_CACHE_DIR`,
  ``tpudl_torch/_build/`` beside the sources (git-ignored), which holds
  them directly, so a checkout that sets nothing builds where it always
  did.

The program store's directory follows the same base
(:func:`tpudl_torch.compile.store.store_dir`: ``<base>/programs``).

A failure is loud, as in tpudl: a directory that cannot be made or
written warns once a process (``RuntimeWarning``), counts
``compile.cache_disabled`` each time, and the kernels build into a
per-process temporary directory.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import warnings
from pathlib import Path

__all__ = ["enable_compilation_cache", "DEFAULT_CACHE_DIR", "kernel_dir"]

DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[1] / "_build")

_warned_disabled = False
_chosen: str | None = None   # an explicit enable_compilation_cache(path)
_private: str | None = None  # this process's own directory, made once


def _note_disabled(path: str, exc: BaseException) -> None:
    """Warn once a process, count every occurrence."""
    global _warned_disabled
    from tpudl_torch.obs import metrics as _m

    _m.counter("compile.cache_disabled").inc()
    if not _warned_disabled:
        _warned_disabled = True
        warnings.warn(
            f"tpudl_torch: kernel-build cache DISABLED ({path!r}: {exc!r}) "
            f"— every process start pays the nvcc build; fix the "
            f"directory or set TPUDL_COMPILE_CACHE_DIR",
            RuntimeWarning, stacklevel=3)


def _writable(path: str) -> None:
    """Make ``path`` and prove a file can be written there (raises)."""
    os.makedirs(path, exist_ok=True)
    probe = os.path.join(path, f".probe.{os.getpid()}")
    with open(probe, "w") as f:
        f.write("")
    os.unlink(probe)


def _kernels_of(base: str) -> str:
    return base if base == DEFAULT_CACHE_DIR else os.path.join(base,
                                                               "kernels")


def enable_compilation_cache(path: str | None = None) -> str | None:
    """Make ``path`` (default: ``$TPUDL_COMPILE_CACHE_DIR``, else
    :data:`DEFAULT_CACHE_DIR`) the process's kernel-build cache. Returns
    the cache directory, or None when the cache is off
    (``TPUDL_COMPILE_CACHE_DIR=0``, silently) or the directory cannot be
    written (loudly); the kernels then build into a temporary directory
    of this process."""
    global _chosen
    env = os.environ.get("TPUDL_COMPILE_CACHE_DIR")
    if env == "0":
        return None
    base = str(path or env or DEFAULT_CACHE_DIR)
    try:
        _writable(_kernels_of(base))
    except OSError as e:
        _note_disabled(base, e)
        return None
    if path:
        _chosen = base
    return base


def _private_dir() -> str:
    global _private
    if _private is None:
        _private = tempfile.mkdtemp(prefix="tpudl_torch-kernels-")
        atexit.register(shutil.rmtree, _private, True)
    return _private


def kernel_dir() -> Path:
    """Where :mod:`tpudl_torch._build` reads and writes the kernel
    libraries now: the explicitly enabled cache, else the one the env
    names (or the default), else — off or unwritable — this process's own
    temporary directory."""
    base = enable_compilation_cache(_chosen)
    if base is None:
        return Path(_private_dir())
    return Path(_kernels_of(base))


def _reset_for_tests() -> None:
    global _warned_disabled, _chosen
    _warned_disabled = False
    _chosen = None
