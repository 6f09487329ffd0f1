"""Build the port's CUDA sources with ``nvcc`` on first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``_build/<name>-<digest>.so``, where the digest covers the
source, every ``csrc/*.cuh`` header and the compiler flags: a changed
kernel rebuilds, an unchanged one loads. Sources compile in parallel, one
``nvcc`` process each. ``torch.utils.cpp_extension`` is deliberately not
used: a source that includes PyTorch's headers takes minutes to compile,
a plain C one seconds.

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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "build", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
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


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every named source (default: all) whose library is missing,
    one ``nvcc`` each, all started together. Returns ``{name: compiler
    output}`` for the sources it compiled (with ``-Xptxas=-v`` that
    output lists each kernel's registers and spills). Raises
    ``RuntimeError`` carrying nvcc's output if any build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
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
