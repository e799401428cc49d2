"""Build and load the port's hand-written CUDA kernels.

Each ``cdfo_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled at first use with ``nvcc`` into a shared library under the
checkout's ``build/cuda/`` (listed in ``.gitignore``), then loaded with
``ctypes``. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused
across processes. There is no fallback: without ``nvcc`` the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
# sm_90a (not sm_90): wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location; raises if none exists."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, PATH and "
        f"{DEFAULT_CUDA_HOME}): the CUDA kernels of cdfo_tpu_torch are "
        "compiled from csrc/ at first use on a GPU, and a CUDA tensor has "
        "no fallback path")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it
    (once per process). The compiler's output, including ``-Xptxas -v``
    register and shared-memory counts, is kept beside the library as
    ``.log``."""
    if name in _LIBS:
        return _LIBS[name]
    out = library_path(name)
    if not out.exists():
        nvcc = find_nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
