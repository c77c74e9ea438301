"""Build and load the package's CUDA kernels (nvcc → shared library → ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``spectrogramgenai_tpu_torch/_build/lib<name>_<hash>.so``. The hash
covers the source and the flags, so an edited kernel rebuilds and a stale
library is never loaded. A file with a plain C interface builds in seconds;
nothing here includes PyTorch's headers. The compiler's ``-Xptxas -v``
report (registers, shared memory, spills per kernel) is kept next to the
library as ``.log``.

nvcc is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then in the
default toolkit location ``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are compiled at first use")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: two processes building the
    # same library at once never load a half-written file
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiling it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            _compile(name, path)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's report from the build of ``csrc/<name>.cu`` ('' if not built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
