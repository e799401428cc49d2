"""Build and load the port's hand-written CUDA kernels.

Each ``cdfo_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled at first use with ``nvcc`` into a shared library under the
checkout's ``build/cuda/`` (listed in ``.gitignore``), then loaded with
``ctypes``. The library's file name carries a hash of every source under
``csrc/`` (each ``.cu`` and the ``.cuh`` headers they share) and of the
flags, so an edited source or header is rebuilt and an unchanged tree is
reused across processes. There is no fallback: without ``nvcc`` the build
raises.

:func:`build` compiles several libraries at once, one ``nvcc`` process
each, all started together.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
# sm_90a (not sm_90): wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# the dtype codes the kernels' C interfaces take (is_bf16)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    """``build/cuda/<name>-<hash>.so``; the hash covers the name, every
    ``*.cu`` and ``*.cuh`` under ``csrc/`` (sorted by name) and the flags."""
    h = hashlib.sha256(f"{name}\0{' '.join(NVCC_FLAGS)}\0".encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(f"{src.name}\0".encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Compile the libraries of ``names`` that are missing, one ``nvcc``
    process per source, all running at once. The compiler's output,
    including ``-Xptxas -v`` register, spill and shared-memory counts, is
    kept beside each library as ``.log``."""
    todo = {n: library_path(n) for n in dict.fromkeys(names)}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        todo[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it
    (once per process)."""
    if name in _LIBS:
        return _LIBS[name]
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    _LIBS[name] = lib
    return lib


def kernel_function(name: str, symbol: str, argtypes):
    """(C function ``symbol`` of library ``name`` returning a cudaError_t,
    the library's ``cdfo_cuda_error_string``)."""
    lib = load_library(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.cdfo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cdfo_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cdfo_cuda_error_string


# -- what every kernel wrapper does before and around a launch ---------------

def kernel_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A torch conv weight (N out, K in, kh, kw) in the layout
    ``csrc/conv3x3_tile.cuh`` reads (its ``Weights``): float32 [tap][N][K];
    bfloat16 the mma B-fragment order [tap][K/16][N/8][g][t][half][pair],
    where lane 4g + t of a warp loads the 4 values n = 8nt + g,
    k = 16kt + 8half + 2t + pair as one 8-byte word."""
    n, k, kh, kw = w.shape
    t = w.permute(2, 3, 0, 1).reshape(kh * kw, n, k).to(dtype)
    if dtype == torch.bfloat16:
        t = t.reshape(kh * kw, n // 8, 8, k // 16, 2, 4, 2) \
            .permute(0, 3, 1, 2, 5, 4, 6)
    return t.contiguous()


def matrix_weights(mats: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-image (N out, K in) matrices (B, N, K) as ``kernel_weights``
    lays out a 1x1 conv, one image per tap: a kernel reads image b's
    matrix as tap b of one ``Weights``."""
    return kernel_weights(mats.permute(1, 2, 0).unsqueeze(-1), dtype)


def forbid_grad(what: str, *tensors: torch.Tensor) -> None:
    """The kernels are inference-only: raise when autograd would record."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is inference-only: its backward is not ported (ROADMAP "
            "Queue 1.4, the recompute backwards of cdfo_tpu/ops/fused_vjp.py);"
            " call it under torch.no_grad() or torch.inference_mode()")


def cached_pack(owner, attr: str, x: torch.Tensor, params, pack, *tag):
    """``pack(x.dtype)``, a module's packed kernel weights, kept on
    ``owner`` as ``attr`` until one of ``params`` changes (new storage or
    an in-place update: keyed on their ``data_ptr`` and ``_version``, with
    x's dtype and ``tag``); None on the CPU, where the plain version runs.
    Parameters made under ``torch.inference_mode`` keep no version counter,
    so nothing tells a kept pack from a stale one: those are packed at
    every call."""
    if x.device.type != "cuda":
        return None
    if any(p.is_inference() for p in params):
        return pack(x.dtype)
    key = (x.dtype, *tag) + tuple((p.data_ptr(), p._version) for p in params)
    if getattr(owner, attr + "_key", None) != key:
        setattr(owner, attr, pack(x.dtype))
        setattr(owner, attr + "_key", key)
    return getattr(owner, attr)


def on_card(t: torch.Tensor, what: str) -> bool:
    """True: launch the kernel (CUDA tensor). False: CPU tensor, plain
    version. Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"{what} has no path for {t.device}")


def check_operands(what: str, *tensors: torch.Tensor,
                   channels: int | None = None) -> None:
    """All of one CUDA device and one dtype (float32 or bfloat16), each
    contiguous and non-empty; with ``channels``, the first tensor's last
    dimension must be it."""
    first = tensors[0]
    if first.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {first.dtype}")
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{what}: operands on {first.device} and "
                             f"{t.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{what}: operands of one dtype, got "
                            f"{first.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous operands")
        if t.numel() == 0:
            raise ValueError(f"{what} got an empty tensor")
    if channels is not None and first.shape[-1] != channels:
        raise ValueError(f"{what} takes NHWC tensors of {channels} channels, "
                         f"got shape {tuple(first.shape)}")


def check_shapes(what: str, shapes) -> None:
    """shapes: {name: (tensor, expected shape)}; raises naming each
    operand of another shape."""
    bad = {n: tuple(t.shape) for n, (t, s) in shapes.items()
           if tuple(t.shape) != tuple(s)}
    if bad:
        raise ValueError(f"{what}: unexpected shapes {bad}")


def check_float32(what: str, device: torch.device,
                  *tensors: torch.Tensor) -> None:
    """The float32 side operands (norm parameters, taps) of a kernel whose
    data operands are of another dtype: float32, contiguous, on
    ``device``."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes its norm parameters and taps in "
                            f"float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{what}: operands on {device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous operands")


def workspace(query, what: str, device: torch.device,
              *sizes: int) -> torch.Tensor:
    """The float32 scratch in which a kernel that reduces over each image
    leaves one partial sum per block (a second launch adds them in a fixed
    order, the same result on every run). ``query`` is the library's
    ``*_workspace`` function, which sizes it for ``sizes`` and the current
    device's SM count; the kernel reads its block count from the size."""
    fn, _ = query
    n = fn(*sizes)
    if n <= 0:
        raise RuntimeError(f"{what}: no workspace for sizes {sizes}")
    return torch.empty(n, dtype=torch.float32, device=device)


def asking(device: torch.device):
    """The context in which a C entry point that asks the current CUDA
    device (its SM count, say) asks ``device``'s: none for a CPU one."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def launch(kernel, what: str, device: torch.device, *args) -> None:
    """Calls ``kernel = (fn, error_string)`` with ``args`` and the current
    stream of ``device``; raises if the launch was refused."""
    fn, err_str = kernel
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
