"""The ranks of ``tests/test_torch_parallel.py``: functions that
``torch.multiprocessing`` starts in fresh processes, one per rank, joined
into a gloo process group by ``cdfo_tpu_torch.parallel.initialize_distributed``
through torchrun's environment. Each writes what it saw to
``<out>/<kind>_rank<r>.pt``. This module imports no JAX (the ranks start
from a fresh import of it)."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.config import DataConfig, TrainConfig
from cdfo_tpu_torch.infer import synthetic_sequence
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.parallel import initialize_distributed, shard_rows
from cdfo_tpu_torch.parallel.serving import ShardedServingEngine
from cdfo_tpu_torch.train import loop as tloop
from cdfo_tpu_torch.train import state as tstate


def spawn(fn, world: int, *args) -> None:
    """Runs ``fn(rank, world, port, *args)`` in ``world`` fresh processes
    and waits for all of them (an exception in any fails the call)."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(fn, args=(world, port, *args), nprocs=world,
                       start_method="spawn", join=True)


def _join(rank: int, world: int, port: int) -> tuple[int, int]:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    got = initialize_distributed("cpu")
    if got != (rank, world) or dist.get_backend() != "gloo":
        raise AssertionError(f"rank {rank}: {got}, {dist.get_backend()}")
    return got


def _save(out: str, kind: str, rank: int, result: dict) -> None:
    torch.save(result, os.path.join(out, f"{kind}_rank{rank}.pt"))


# -- sharded serving -----------------------------------------------------------

def serve_rank(rank, world, port, runs, cfg, k_per_device, out):
    """``runs``: (mask_mode, T, weights), each served untimed and timed
    (16x24, seed 5). Rank 0's model takes ``weights``, the others start
    from other seeds: the engine broadcasts rank 0's. Also keeps the inputs
    the rank staged for the first step and, under the sampled mask, the
    rings after the last step."""
    _join(rank, world, port)
    result = {}
    for mask_mode, t, weights in runs:
        model = CVSRV8(ModelConfig(mask_mode=mask_mode, **cfg),
                       torch.Generator().manual_seed(rank), device="cpu")
        if rank == 0:
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in weights.items()})
        eng = ShardedServingEngine(model, k_per_device=k_per_device)
        data = synthetic_sequence(t=t, h=16, w=24, seed=5)
        frames, fps = eng.run_sequence(data)
        timed, timed_fps = eng.run_sequence(data, collect_timing=True)
        boot, steps = eng.stage_sequence(data)
        got = {"frames": frames, "fps": fps, "timed": timed,
               "timed_fps": timed_fps, "k": eng.k,
               "staged_lrs": steps[0][0][0].numpy(),
               "staged_cidx": steps[0][0][7].numpy(),
               "weights": {k: v.clone()
                           for k, v in model.state_dict().items()}}
        if mask_mode == "sample":
            eng.generator.set_state(eng._generator_state)
            with torch.inference_mode():
                got["rings"] = [r.clone() for r in eng.run_staged(boot,
                                                                  steps)[0]]
        result[mask_mode, t] = got
    _save(out, "serve", rank, result)
    dist.destroy_process_group()


# -- data-parallel training ----------------------------------------------------

def tiny_model(weights, cfg, seed):
    model = CVSRV8(ModelConfig(**cfg), torch.Generator().manual_seed(seed),
                   device="cpu")
    if weights is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    return model


def train_rank(rank, world, port, weights, cfg, batches, u, bad, root, out):
    """Two steps on the rank's rows of ``batches`` with the global gumbel
    draw ``u``; a step on ``bad`` (rank 1's rows hold a NaN target); a step
    drawing its noise from a generator seeded 5. Then two ``train_loop``
    runs over the synthetic tree at ``root``: one epoch (a checkpoint at its
    end), then a second epoch resumed from it."""
    _join(rank, world, port)
    state = tstate.TrainState(tiny_model(weights if rank == 0 else None,
                                         cfg, rank), TrainConfig())
    result = {"data_parallel": state.data_parallel, "losses": []}
    for b in batches:
        loss = tstate.train_step(state, shard_rows_of(b, rank, world),
                                 gumbel_u=torch.from_numpy(u))
        result["losses"].append(loss.item())
    before = [p.detach().clone() for p in state.masters]
    loss = tstate.train_step(state, shard_rows_of(bad, rank, world),
                             gumbel_u=torch.from_numpy(u))
    result["guard"] = {
        "loss": loss.item(), "step": state.step,
        "same": all(torch.equal(a, b) for a, b in zip(before, state.masters)),
        "grads_cleared": all(t.grad is None
                             for t in state.masters + state.params)}
    gen = torch.Generator().manual_seed(5)
    result["losses"].append(tstate.train_step(
        state, shard_rows_of(batches[0], rank, world), gen).item())
    result["params"] = {k: v.clone() for k, v in
                        state.model.state_dict().items()}
    result["steps"] = state.step
    result["ckpt"] = loop_runs(rank, world, root, out)
    _save(out, "train", rank, result)
    dist.destroy_process_group()


def shard_rows_of(batch: dict, rank: int, world: int) -> dict:
    return {k: shard_rows(v, rank, world) for k, v in batch.items()}


LOOP_MODEL = dict(nf=16, scn_groups=1, mask_mode="sample")
LOOP_DATA = DataConfig(crop_size=16, frames_per_seq=10)


def loop_runs(rank, world, root, out) -> dict:
    train_cfg = TrainConfig(batch_size=1, val_interval=1,
                            ckpt_dir=os.path.join(out, "run"))
    seen = {}

    def on_start(state):
        seen["start"] = {k: v.clone() for k, v in
                         state.model.state_dict().items()}
        seen["start_step"] = state.step

    first = tloop.train_loop(ModelConfig(**LOOP_MODEL), LOOP_DATA, train_cfg,
                             root, num_epochs=1, steps_per_epoch=1,
                             device="cpu", host_id=rank, num_hosts=world)
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    ckpt_dir, log_path = tloop.run_dirs(train_cfg, LOOP_DATA)
    files = sorted(os.listdir(ckpt_dir))
    second = tloop.train_loop(ModelConfig(**LOOP_MODEL), LOOP_DATA, train_cfg,
                              root, num_epochs=2, steps_per_epoch=1,
                              device="cpu", on_start=on_start, host_id=rank,
                              num_hosts=world)
    dist.barrier()
    with open(log_path) as f:
        log = f.read().splitlines()
    return {"files_after_first": files, "saved": saved,
            "resumed": seen["start"], "resumed_step": seen["start_step"],
            "final_step": second.step, "log": log,
            "files": sorted(os.listdir(ckpt_dir)),
            "final": {k: v.clone() for k, v in
                      second.model.state_dict().items()}}
