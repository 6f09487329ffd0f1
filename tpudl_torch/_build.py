"""Build the port's CUDA sources with ``nvcc`` on first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``<name>-<digest>.so`` in the kernel-build cache
(:func:`tpudl_torch.compile.cache.kernel_dir`: ``_build/`` by default,
``<dir>/kernels`` under ``TPUDL_COMPILE_CACHE_DIR=<dir>``, a directory of
the process's own under ``=0``), where the digest covers the source,
every ``csrc/*.cuh`` header, the compiler flags and the toolkit (the
resolved ``nvcc`` binary's path, size and modification time, read with
one ``stat``): a changed kernel or toolkit rebuilds, an unchanged one
loads; a host without nvcc loads what a toolkit built. Sources compile
in parallel, one ``nvcc`` process each. ``torch.utils.cpp_extension`` is
deliberately not used: a source that includes PyTorch's headers takes
minutes to compile, a plain C one seconds.

Nothing here runs at import time; the first call to :func:`library`
builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "build_dir",
           "build", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"   # the default cache
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_TIMEOUT_S = 600


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
            "port's CUDA kernels are built from source on the machine "
            "with the card")
    return path


def build_dir() -> Path:
    """The directory the kernel libraries live in now (the kernel-build
    cache, :func:`tpudl_torch.compile.cache.kernel_dir`)."""
    from tpudl_torch.compile.cache import kernel_dir

    return kernel_dir()


def _toolkit() -> str | None:
    """The toolkit's identity in a library's name: the resolved ``nvcc``
    binary's path, size and modification time (one ``stat``, no process;
    an upgrade replaces the binary), or None where there is no nvcc."""
    try:
        real = os.path.realpath(_nvcc())
        st = os.stat(real)
    except (OSError, RuntimeError):
        return None
    return f"{real}:{st.st_size}:{st.st_mtime_ns}"


def _target(name: str, where: Path | None = None) -> Path:
    """``<name>-<source digest>-<toolkit digest>.so``. Without an nvcc, the
    newest library built from this source by any toolkit, if one is
    there."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    stem = f"{name}-{h.hexdigest()[:16]}"
    where = where or build_dir()
    tool = _toolkit()
    if tool is None:
        built = sorted(where.glob(f"{stem}-" + "?" * 8 + ".so"),
                       key=lambda p: p.stat().st_mtime_ns)
        if built:
            return built[-1]
        tool = ""
    return where / f"{stem}-{hashlib.sha1(tool.encode()).hexdigest()[:8]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every named source (default: all) whose library is missing,
    one ``nvcc`` each, all started together. Returns ``{name: compiler
    output}`` for the sources it compiled (with ``-Xptxas=-v`` that
    output lists each kernel's registers and spills). Raises
    ``RuntimeError`` carrying nvcc's output if any build fails."""
    names = sources() if names is None else list(names)
    where = build_dir()
    where.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            out = _target(name, where)
            if out.exists():
                continue
            nvcc = _nvcc()
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            logs[name], _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode:
                failed.append(name)
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half a .so
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    build([name])
    return ctypes.CDLL(str(_target(name)))
