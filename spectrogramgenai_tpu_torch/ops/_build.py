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


def _compile(names: list[str]) -> None:
    """Compile the sources, one nvcc each, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, jobs = find_nvcc(), []
    try:
        for name in names:
            # build under a temporary name, then rename: two processes building
            # the same library at once never load a half-written file
            out = library_path(name)
            fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
            jobs.append((name, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, out, tmp, proc in jobs:
            report = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{report}")
                continue
            out.with_suffix(".log").write_text(report)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def build(names) -> None:
    """Compile those of ``csrc/<name>.cu`` that are not built yet, in parallel, and load them."""
    with _lock:
        names = [n for n in names if n not in _loaded]
        missing = [n for n in names if not library_path(n).exists()]
        if missing:
            _compile(missing)
        for name in names:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiling it if needed."""
    lib = _loaded.get(name)  # every launch comes here: no file system work once loaded
    if lib is None:
        build([name])
        lib = _loaded[name]
    return lib


def build_log(name: str) -> str:
    """nvcc's report from the build of ``csrc/<name>.cu`` ('' if not built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
