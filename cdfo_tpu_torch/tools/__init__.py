"""The port's command-line tools, each run as ``python -m
cdfo_tpu_torch.tools.<name>``: ``train``, the trainer (data-parallel under
``torchrun`` with ``--distributed``), ``serve``, the streaming server
(sharded over ``torchrun``'s ranks), ``dryrun``, the multi-card dry run,
and ``test_sr``,
``eval_jctvc``, ``int8_delta`` and ``gumbel_variance``, the evaluation
tools (ports of the repository's ``tools/`` scripts of those names, with
their flags; on the card, or on the CPU with ``--cpu``; the last two on
``structured``'s small trained model); the trunk's microbenchmarks on the
GPU, ports of the TPU tools ``microbench_trunk``, ``microbench_dots`` and
``microbench_dma`` (with their arguments and defaults); and
``compare_block``, a kernel (the
exact or int8 ``Block_``, the alignment tail) against another checkout's.
The microbenchmarks and ``compare_block`` run on the card only: without
CUDA they raise."""
from __future__ import annotations

import torch


def require_card(tool: str) -> str:
    """The card's name; raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} measures hand-written CUDA kernels and "
                           "has no CPU mode: torch.cuda.is_available() is "
                           "False")
    return torch.cuda.get_device_name(0)


def event_ms(fn, reps: int, warmup: int = 1) -> list[float]:
    """The milliseconds of each of ``reps`` calls of ``fn()`` (CUDA events,
    after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def captured(fn, *wrappers):
    """``fn()`` captured once into a CUDA graph (after one warm-up call that
    builds the kernel's library); returns a function that replays it. A
    replay launches the same kernels without the host's per-call work, so
    kernels shorter than that work are timed without the gaps it leaves.
    The capture launches nothing: the counts that ``wrappers`` (those ``fn``
    calls) took during it are taken back and added at each replay instead,
    so ``launches`` counts the kernels that ran."""
    fn()
    torch.cuda.synchronize()
    before = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    per_replay = [w.launches - b for w, b in zip(wrappers, before)]
    for w, b in zip(wrappers, before):
        w.launches = b

    def replay():
        graph.replay()
        for w, n in zip(wrappers, per_replay):
            w.launches += n

    return replay
