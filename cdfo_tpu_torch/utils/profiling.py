"""Profiling, FLOP and parameter-count utilities (counterpart of
``cdfo_tpu/utils/profiling.py``): the reference's ``CVSR_V8_flops`` wrapper
(`arch/SIDECVSR_our.py:5135-5252`) and its ``sum(np.prod(p.size()))``
parameter print (`train_LD_37.py:166,423`), and a device profiler.

``estimate_flops`` counts with ``torch.utils.flop_counter.FlopCounterMode``:
matrix products, convolutions and attention, two operations a
multiply-accumulate, and nothing else (no elementwise op, no reduction,
no gather). ``cdfo_tpu``'s count is XLA's cost analysis, which counts every
operation, so the two are different measures. A hand-written kernel is
opaque to the counter: count a model built without the kernel flags.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..tools import event_ms


def count_params(module: torch.nn.Module) -> int:
    """The number of parameter values of ``module`` (buffers excluded)."""
    return int(sum(p.numel() for p in module.parameters()))


def estimate_flops(fn: Callable, *args) -> float:
    """The operations ``fn(*args)`` runs (one call, under ``no_grad``) as
    ``FlopCounterMode`` counts them: products and convolutions only."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


@contextlib.contextmanager
def trace_profile(logdir: str):
    """A ``torch.profiler`` trace of the block (the CPU, and the card where
    there is one), written on exit into ``logdir`` as a
    ``*.pt.trace.json`` that TensorBoard's profiler plugin (or
    chrome://tracing) opens. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


class Timer:
    """Times calls, in seconds (``times``, ``mean``): on a CUDA ``device``
    by CUDA events around each call (``tools.event_ms``), elsewhere by the
    host clock."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.times: list[float] = []

    def time(self, fn: Callable, reps: int = 1, warmup: int = 0) -> list:
        """Runs ``fn()`` ``warmup`` times untimed, then ``reps`` timed;
        returns (and keeps) the ``reps`` times."""
        if self.device.type == "cuda":
            times = [ms / 1e3 for ms in event_ms(fn, reps, warmup)]
        else:
            for _ in range(warmup):
                fn()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
        self.times += times
        return times

    @contextlib.contextmanager
    def measure(self):
        """The host-clock time of the block, the device synchronized at its
        start and end (``sync``)."""
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.times.append(time.perf_counter() - t0)

    def sync(self, x=None):
        """Waits for the device's queued work (on the CPU it is done);
        returns ``x``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return x

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0
