"""The native C++ batch sampler (``cdfo_tpu/data/native.py`` over
``csrc/batcher.cpp``, a copy of ``native/batcher.cpp``), loaded with
``ctypes``.

``NativeBatcher`` gives ``TrainBatcher``'s batch dict (without ``qp``) with
the per-sample Python loop replaced by one OpenMP-parallel C++ call. Its
draws are its own: each sample seeds an ``mt19937_64`` from the batch seed
(``csrc/batcher.cpp:62-77``), where ``TrainBatcher`` draws from numpy's
generator, so the two give the same batches only where nothing is drawn
(one sequence, ``crop`` the frame size, ``augment=False``). It expands the
centre MV the LD way for every config, so it refuses an RA dataset
(``TrainBatcher`` expands RA as the reference does).

The library is compiled at first use with :data:`COMPILE` into the
checkout's ``build/native/`` (listed in ``.gitignore``); its name carries a
hash of the source, the flags and the CPU that ``-march=native`` resolves
to, and it is written under a temporary name and moved into place, so
processes that build at once each load a whole library. Where it cannot be
built, :func:`load` raises naming the command.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
COMPILER = "g++"
# the flags of tools/build_native.sh
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
# the seed step between batches (cdfo_tpu/data/native.py:90)
SEED_STEP = 0x10001

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def compile_command(out: Path) -> list[str]:
    return [COMPILER, *FLAGS, str(SOURCE), "-o", str(out)]


def _target() -> str:
    """What ``-march=native`` means on this host, as the compiler reports
    it (the library is built for this CPU)."""
    out = subprocess.run([COMPILER, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True).stdout
    return " ".join(line.split()[-1] for line in out.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def library_path() -> Path:
    """``build/native/batcher-<hash>.so``: the hash covers the source, the
    flags and the CPU the compiler targets."""
    h = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + _target().encode()
                       + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"batcher-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    try:
        out = library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = compile_command(tmp)
        done = subprocess.run(cmd, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"cannot build the native batcher with "
                           f"{' '.join(compile_command(Path('<lib>.so')))}: "
                           f"{e}") from e
    if done.returncode != 0:
        raise RuntimeError(f"cannot build the native batcher: {' '.join(cmd)} "
                           f"exited {done.returncode}:\n{done.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The batcher's library, built if missing (once per process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.sample_batch.argtypes = [
                u8, u8, u8, i8, u8, i8, i8,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
                f32, f32, f32, f32, f32, f32, f32,
            ]
            lib.sample_batch.restype = None
            _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the library is built or can be built here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


class NativeBatcher:
    """Batches of ``batch_size`` ``crop`` x ``crop`` windows of ``nframes``
    frames from ``ds`` (a ``CVCPDataset`` of an LD config), drawn by the C++
    sampler from ``seed``, which advances by ``SEED_STEP`` a batch."""

    def __init__(self, ds, batch_size: int, crop: int = 64, seed: int = 4,
                 zero_mvl1: Optional[bool] = None, augment: bool = True,
                 nframes: int = 7):
        if ds.cfg.coding_cfg == "RA":
            raise ValueError(
                "NativeBatcher expands the centre MV the LD way and has no "
                "RA expansion (csrc/batcher.cpp); use TrainBatcher for RA")
        self.lib = load()
        self.ds = ds
        self.b = batch_size
        self.crop = crop
        self.n = nframes
        self.augment = augment
        self.zero_mvl1 = (ds.cfg.zero_mvl1_in_train
                          if zero_mvl1 is None else zero_mvl1)
        self.seed = seed % 2**64
        # contiguous copies once (memmapped caches may be read-only views)
        self._lr = np.ascontiguousarray(ds.lr)
        self._hr = np.ascontiguousarray(ds.hr)
        self._pm = np.ascontiguousarray(ds.pm)
        self._rm = np.ascontiguousarray(ds.rm, dtype=np.int8)
        # the 272-row unfiltered frames align with 270-row LR on rows 0..269
        self._uf = np.ascontiguousarray(ds.uf[:, :, :self._lr.shape[2]])
        self._mv0 = np.ascontiguousarray(ds.mv0, dtype=np.int8)
        self._mv1 = np.ascontiguousarray(ds.mv1, dtype=np.int8)

    def sample_batch(self) -> dict:
        s, t, h, w = self._lr.shape
        b, n, cr = self.b, self.n, self.crop
        if t < n or h < cr or w < cr:
            raise ValueError(f"{n} frames of {cr}x{cr} from sequences of "
                             f"{t} frames of {h}x{w}")
        out_lr = np.empty((b, n, cr, cr, 1), np.float32)
        out_hr = np.empty((b, 4 * cr, 4 * cr, 1), np.float32)
        out_pm = np.empty_like(out_lr)
        out_rm = np.empty_like(out_lr)
        out_uf = np.empty_like(out_lr)
        out_mv0 = np.empty((b, n, cr, cr, 2), np.float32)
        out_mv1 = np.empty_like(out_mv0)
        self.lib.sample_batch(
            self._lr, self._hr, self._pm, self._rm, self._uf,
            self._mv0, self._mv1, s, t, h, w, b, n, cr,
            self.seed, int(self.augment), int(self.zero_mvl1),
            out_lr, out_hr, out_pm, out_rm, out_uf, out_mv0, out_mv1)
        self.seed = (self.seed + SEED_STEP) % 2**64
        return {"lrs": out_lr, "mvs0": out_mv0, "mvs1": out_mv1,
                "pms": out_pm, "rms": out_rm, "ufs": out_uf, "hr": out_hr}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.sample_batch()

    def prefetch(self, depth: int = 2) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=depth)

        def worker():
            while True:
                q.put(self.sample_batch())

        threading.Thread(target=worker, daemon=True).start()
        while True:
            yield q.get()
