"""Build and load the package's native libraries (compiler → shared library → ctypes).

Each ``csrc/<name>.cu`` (a CUDA kernel) exposes a plain C interface and is
compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

and each ``csrc/<name>.cpp`` (host code: the WAV and PNG codecs) with

    g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off <source> <HOST_LIBS[name]>

into ``spectrogramgenai_tpu_torch/_build/lib<name>_<hash>.so``. The hash
covers the source, the flags and the libraries, so an edited source
rebuilds and a stale library is never loaded. A file with a plain C
interface builds in seconds; nothing here includes PyTorch's headers. The
compiler's report (for a kernel ``-Xptxas -v``: registers, shared memory,
spills per kernel) is kept next to the library as ``.log``. A failed build
raises; no caller has a fallback.

nvcc is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then in the
default toolkit location ``/usr/local/cuda/bin``; the host compiler is
``$CXX``, else ``g++`` on ``PATH``.
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
# no -march=native: a library built on one host may be loaded on another
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off", "-Wall")
HOST_LIBS = {"png_batch": ("-lz", "-lpthread"), "wav_batch": ("-lpthread",)}

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


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH): the host codecs are compiled at first use")
    return cxx


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` if there is one, else ``csrc/<name>.cpp``."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _flags(name: str, src: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS + HOST_LIBS.get(name, ())


def library_path(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes() + "\0".join(_flags(name, src)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(names: list[str]) -> None:
    """Compile the sources, one compiler each, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in names:
            # build under a temporary name, then rename: two processes building
            # the same library at once never load a half-written file
            src, out = _source(name), library_path(name)
            fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp", dir=BUILD_DIR)
            os.close(fd)
            if src.suffix == ".cu":
                cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
            else:  # the libraries go after the source that needs them
                cmd = [find_cxx(), *HOST_FLAGS, "-o", tmp, str(src), *HOST_LIBS.get(name, ())]
            jobs.append((src, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, out, tmp, proc in jobs:
            report = proc.communicate()[0]
            if proc.returncode != 0:
                compiler = "nvcc" if src.suffix == ".cu" else "g++"
                failed.append(f"{compiler} failed for {src.name} (exit {proc.returncode}):\n{report}")
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
    """Compile those of ``csrc/<name>.cu`` / ``.cpp`` that are not built yet, in parallel, and load them."""
    with _lock:
        names = [n for n in names if n not in _loaded]
        missing = [n for n in names if not library_path(n).exists()]
        if missing:
            _compile(missing)
        for name in names:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``), compiling it if needed."""
    lib = _loaded.get(name)  # every launch comes here: no file system work once loaded
    if lib is None:
        build([name])
        lib = _loaded[name]
    return lib


def build_log(name: str) -> str:
    """The compiler's report from the build of ``csrc/<name>`` ('' if not built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
