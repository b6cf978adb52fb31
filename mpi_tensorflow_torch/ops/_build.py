"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds instead of the minutes
``torch.utils.cpp_extension`` needs.  The build runs at first use, never
at import, into ``build/torch_kernels/`` at the repository root (listed
in ``.gitignore``), under a file name keyed by a hash of the source, the
headers under ``csrc/`` and the flags: a changed source, header or flag
set builds a new library, an unchanged one is reused.  ``build_all`` starts one ``nvcc`` per missing
source, all at once, and waits for every one.

A missing ``nvcc`` or a failed compile raises; nothing here falls back
to a plain PyTorch path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: library name -> its CUDA source under csrc/
SOURCES = {"paged_attention": "paged_attention.cu",
           "flash_attention": "flash_attention.cu",
           "fused": "fused.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    usual place, else ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this machine")
    return found


def library_path(name: str) -> Path:
    """Where library ``name`` is built: under a hash of its source, of
    every header under ``csrc/`` (any source may include any of them) and
    of the flags."""
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(p for p in CSRC.iterdir()
                         if p.suffix in (".cuh", ".h")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every listed library that is not built yet, one ``nvcc``
    process per source, all started together.  Returns ``{name:
    compiler output}`` for the libraries built by this call (ptxas's
    register and shared-memory report among it)."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        # compile to a private name, then rename: a concurrent or
        # interrupted build never leaves a half-written library behind
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed (once per
    process)."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
