"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/<name>-<hash>.so`` beside this file (the directory is
git-ignored). The hash covers the source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source is rebuilt at its next
use. :func:`build_all` starts one ``nvcc`` per
missing library, all at once, and waits for them. Nothing is built when the
module is imported: the CPU tests import it on machines without ``nvcc``.

No ``--use_fast_math``: the quantizers need IEEE division and ``rintf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
SOURCES = ("analog_matmul", "int4_matmul", "paged_attention",
           "paged_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built")


def library_path(name: str) -> pathlib.Path:
    """Where the shared library of ``csrc/<name>.cu`` lives for its hash."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel. Returns ``{name: log}``
    with ptxas's register and shared-memory report (empty when the library
    was already built). Raises with nvcc's output if a build fails."""
    pending = {n: library_path(n) for n in names
               if not library_path(n).is_file()}
    if not pending:
        return {n: "" for n in names}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in pending.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {n: "" for n in names}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it at first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.is_file():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
