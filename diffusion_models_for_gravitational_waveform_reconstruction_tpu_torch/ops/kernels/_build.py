"""Build the port's CUDA sources (``csrc/*.cu``) at first use and load them.

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, loaded with ``ctypes``; nothing includes PyTorch's headers, so a
build takes seconds.  The sources share the Hopper helpers of
``csrc/hopper.cuh``.  The library's file name carries a digest of the
source, the headers and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as built.  :func:`build_all` compiles every
source at once, one ``nvcc`` process each.  Libraries go to ``_build/``
inside the package (listed in ``.gitignore``); the compiler's resource
report (``-Xptxas -v``) is kept beside each library as ``<library>.log``.

Nothing here runs at import: the CPU tests import every module, and there is
no ``nvcc`` without the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (``CUDA_HOME`` defaults to
    ``/usr/local/cuda``), else ``nvcc`` on the PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the "
                           "PATH (the port's CUDA kernels build only with the "
                           "CUDA toolkit)")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name carries a digest of the
    source, of every ``csrc/*.cuh`` (any source may include them) and of
    the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(names: List[str]) -> Dict[str, str]:
    """Start one ``nvcc`` per source in ``names``, all at once, wait for all
    of them, and return ``{name: compiler report}``.  Raises with the output
    of every build that failed."""
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = Path(f"{tmp}.log")
        with open(log, "w") as f:   # a file, not a pipe: no build can block
            proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                     str(CSRC / f"{name}.cu")],
                                    stdout=f, stderr=subprocess.STDOUT)
        jobs[name] = (proc, out, tmp, log)
    reports, failed = {}, []
    for name, (proc, out, tmp, log) in jobs.items():
        rc = proc.wait()
        reports[name] = log.read_text()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n{reports[name]}")
            continue
        os.replace(log, f"{out}.log")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    compiler's report, or None when the library was already built.  Raises
    with the compiler's output when the build fails."""
    if library_path(name).exists():
        return None
    return _compile([name])[name]


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` that is not built yet, one ``nvcc`` each,
    all started together.  Returns ``{name: compiler report}`` of the
    sources built by this call."""
    return _compile([p.stem for p in sorted(CSRC.glob("*.cu"))
                     if not library_path(p.stem).exists()])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
