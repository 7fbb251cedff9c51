"""Build the port's hand-written CUDA kernels at first use and load them
through ``ctypes``.

Each kernel source under a ``csrc/`` directory exports a plain C
function, so ``nvcc`` compiles it in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -shared -Xcompiler -fPIC -o <lib>.so <source>.cu

Libraries land in ``paddle_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, of every
local header it includes (``#include "..."``, followed recursively) and
of the flags, so an edited source or header is rebuilt and a stale
library is never loaded. :func:`build` compiles several sources in
parallel (one ``nvcc`` process each, all started together); nothing is
built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KernelLibrary", "build"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the port's "
                           "CUDA kernels cannot be built")
    return found


class KernelLibrary:
    """One CUDA source compiled to one shared library, loaded once.

    ``declare`` maps exported C function names to ``(argtypes,
    restype)``; every pointer and the stream are ``ctypes.c_void_p`` so
    no 64-bit value is cut to 32 bits."""

    def __init__(self, source: Path, declare: dict):
        self.source = Path(source)
        self.declare = declare
        self._lib = None
        self.build_seconds = None

    def sources(self):
        """The source and the local headers it includes, recursively
        (paths relative to the including file), in a stable order."""
        seen, todo = [], [self.source]
        while todo:
            path = todo.pop(0)
            if path in seen:
                continue
            seen.append(path)
            for name in _LOCAL_INCLUDE.findall(path.read_text()):
                todo.append((path.parent / name).resolve())
        return seen

    @property
    def path(self) -> Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in self.sources():
            digest.update(path.read_bytes())
        return BUILD_DIR / f"lib{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def _command(self, out):
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def start_build(self):
        """Start ``nvcc`` for this library unless it is built already.
        Returns ``(process, tmp_path)`` or ``None``."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.Popen(self._command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started, t0):
        if started is None:
            return
        proc, tmp = started
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{out}")
        os.replace(tmp, self.path)
        self.build_seconds = time.perf_counter() - t0

    def lib(self):
        """The loaded library, built first if needed."""
        if self._lib is None:
            t0 = time.perf_counter()
            self.finish_build(self.start_build(), t0)
            lib = ctypes.CDLL(str(self.path))
            for name, (argtypes, restype) in self.declare.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            self._lib = lib
        return self._lib


def build(libraries):
    """Compile every library that is not built yet, all ``nvcc``
    processes running at once, then load each. Returns the seconds the
    whole build took."""
    t0 = time.perf_counter()
    started = [(lib, lib.start_build()) for lib in libraries]
    errors = []
    for lib, st in started:  # wait for every nvcc before raising
        try:
            lib.finish_build(st, t0)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.lib()
    return time.perf_counter() - t0
