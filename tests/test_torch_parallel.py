"""The port's multi-card paths on CPU ranks (gloo), against the port's own
single-process paths and against ``cdfo_tpu``'s sharded engine.

Two kinds of run, each one ``torch.multiprocessing`` spawn of two ranks
(``tests/torch_parallel_ranks.py``):

- serving: ``ShardedServingEngine`` at ``k_per_device=2`` (k = 4) on a tiny
  float32 CVSR_V8 (nf 32, one trunk group, 16x24) with JAX's weights
  (``from_flax``), T = 10 (a tail past the last full step) and T = 3 (less
  than one step), the expected mask; and T = 10 under the sampled mask;
- training: two data-parallel ``train_step``s of a tiny CVSR_V8 (nf 32,
  two trunk groups, 16x16, one row a rank) with an injected global gumbel
  draw, a step whose target is NaN on rank 1 alone, a step drawing its
  noise from a seeded generator; then ``train_loop`` for one epoch and a
  second resumed from its checkpoint.

The engine's frames must equal the port's single engine (k = 4) bit for bit
and ``cdfo_tpu``'s ``ShardedServingEngine`` on two devices of the CPU mesh
within 1 LSB (one JAX engine, one compile); the trainer's parameters must
be within 1e-5 relative (L2, per tensor) of one process on the
concatenated batches. That process's step is held against ``cdfo_tpu``'s
by ``tests/test_torch_train.py``.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.infer.pipeline import synthetic_sequence as j_synthetic
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu.parallel.mesh import make_mesh
from cdfo_tpu.parallel.serving import ShardedServingEngine as JSharded
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
from cdfo_tpu_torch.parallel import (all_gather_rows, initialize_distributed,
                                     rank_device, shard_rows)
from cdfo_tpu_torch.train import state as tstate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, KPD = 2, 2
NF, H, W = 32, 16, 24
SERVE_CFG = dict(nf=NF, scn_groups=1)
TRAIN_CFG = dict(nf=NF, scn_groups=2, mask_mode="sample")
TH = TW = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(out, kind):
    return [torch.load(os.path.join(out, f"{kind}_rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


# -- serving ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_weights():
    """JAX's init of the tiny model, one channel of the EGLA mask put on
    (the long-range attention carries signal), and the port's copy; a
    second copy with a second channel on, so that the sampled mask's noise
    decides pixel by pixel which of the two passes 0.5."""
    jmodel = JCVSRV8(JModelConfig(mask_mode="expected", **SERVE_CFG))
    d = np.zeros((1, 7, H, W, 1), np.float32)
    dm = np.zeros((1, 7, H, W, 2), np.float32)
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), d, dm, dm, d, d, d))
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    sampled = jax.tree.map(np.copy, params)
    sampled["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][5] += 10.0

    def port(p):
        return {k: v.numpy() for k, v in from_flax(p).items()}

    return jmodel, params, port(params), port(sampled)


@pytest.fixture(scope="module")
def served(jax_weights, tmp_path_factory):
    _, _, weights, sampled = jax_weights
    out = str(tmp_path_factory.mktemp("serve"))
    runs = [("expected", 10, weights), ("expected", 3, weights),
            ("sample", 10, sampled)]
    ranks.spawn(ranks.serve_rank, WORLD, runs, SERVE_CFG, KPD, out)
    return load(out, "serve")


def port_model(weights, mask_mode="expected"):
    model = ranks.CVSRV8(ModelConfig(mask_mode=mask_mode, **SERVE_CFG),
                         torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model


@pytest.mark.parametrize("t", [10, 3])
def test_sharded_engine_equals_the_single_engine(jax_weights, served, t):
    """Both ranks return every frame, equal bit for bit to the single
    engine's at k = 4, untimed and timed; rank 1's model took rank 0's
    weights."""
    single, _ = BatchedStreamingEngine(port_model(jax_weights[2]), k=4) \
        .run_sequence(synthetic_sequence(t=t, h=H, w=W, seed=5))
    assert single.shape == (t, 4 * H, 4 * W)
    for got in (r["expected", t] for r in served):
        assert got["k"] == WORLD * KPD
        np.testing.assert_array_equal(got["frames"], single)
        np.testing.assert_array_equal(got["timed"], single)
        assert got["fps"] is None and got["timed_fps"] > 0
        for k, v in got["weights"].items():
            assert torch.equal(v, torch.from_numpy(jax_weights[2][k])), k


def test_each_rank_stages_its_own_rows(jax_weights, served):
    """Step 0 of T = 10: rank r uploads the new frames (centre + 3) and the
    ring slots of centres 2r and 2r + 1 only."""
    data = synthetic_sequence(t=10, h=H, w=W, seed=5)
    eng = BatchedStreamingEngine(port_model(jax_weights[2]), k=4)
    for r, got in enumerate(served):
        centers = [KPD * r, KPD * r + 1]
        np.testing.assert_array_equal(
            got["expected", 10]["staged_lrs"][..., 0],
            data.lr[[c + 3 for c in centers]])
        np.testing.assert_array_equal(
            got["expected", 10]["staged_cidx"],
            [(c + eng._S) % eng._L for c in centers])


@pytest.fixture(scope="module")
def jax_sharded(jax_weights):
    jmodel, params, _, _ = jax_weights
    mesh = make_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    return JSharded(jmodel, params, mesh, k_per_device=KPD)


@pytest.mark.parametrize("t", [10, 3])
def test_sharded_engine_matches_cdfo_tpu(jax_sharded, served, t):
    ref, _ = jax_sharded.run_sequence(j_synthetic(t=t, h=H, w=W, seed=5))
    diff = np.abs(served[0]["expected", t]["frames"].astype(np.int32)
                  - ref.astype(np.int32))
    assert ref.shape == (t, 4 * H, 4 * W)
    assert diff.max() <= 1, (diff.max(), (diff > 1).sum())


def test_sampled_mask_draws_each_ranks_frames_alike(jax_weights, served):
    """Under the sampled mask every rank's generator starts alike, as the
    JAX engine hands every chip one key: the bootstrap draws for its k + 6
    frames, each step's draw covers a rank's own 2 frames, so both ranks'
    frames take one draw. The single engine with that rule (each step's
    draw of 2 frames repeated for the other rank's) writes the same rings,
    bit for bit, and its own draws (one of 4 frames a step) other rings."""
    data = synthetic_sequence(t=10, h=H, w=W, seed=5)
    tiny = torch.finfo(torch.float32).tiny

    def rings(rule):
        model = port_model(jax_weights[3], "sample")
        eng = BatchedStreamingEngine(model, k=4)
        gen = torch.Generator().manual_seed(0)
        if rule:
            def compensate(lrs, *rest):
                m = lrs.shape[0]
                shape = (KPD if m == eng.k else m, H, W, NF)
                u = torch.rand(shape, generator=gen).clamp_min_(tiny)
                if m == eng.k:
                    u = u.repeat(WORLD, 1, 1, 1)
                return model.compensate_frames(lrs, *rest, gumbel_u=u)
            eng._compensate = compensate
        else:
            eng.generator = gen
        with torch.inference_mode():
            return eng.run_staged(*eng.stage_sequence(data))[0]

    ruled, single = rings(True), rings(False)
    for got in served:
        for mine, ref, other in zip(got["sample", 10]["rings"], ruled, single):
            assert torch.equal(mine, ref)
        np.testing.assert_array_equal(got["sample", 10]["frames"],
                                      got["sample", 10]["timed"])
    fi = (ruled[1] - single[1]).abs().max() / single[1].abs().max()
    assert fi > 1e-3, fi


# -- training --------------------------------------------------------------------

def batch(seed, rows=WORLD):
    r = np.random.RandomState(seed)
    lrs, pms, rms, ufs = (r.rand(rows, 7, TH, TW, 1).astype(np.float32)
                          for _ in range(4))
    mvs = (r.randn(rows, 7, TH, TW, 2) * 1.5).astype(np.float32)
    return {"lrs": lrs, "mvs0": mvs, "mvs1": mvs, "pms": pms, "rms": rms,
            "ufs": ufs, "hr": r.rand(rows, 4 * TH, 4 * TW, 1)
            .astype(np.float32)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The two ranks' run and one process's on the concatenated batches,
    from the same weights: (ranks' results, one process's state, losses)."""
    from cdfo_tpu_torch.data.io import make_synthetic_cvcp_tree
    weights = {k: v.numpy() for k, v in
               ranks.tiny_model(None, TRAIN_CFG, 3).state_dict().items()}
    batches = [batch(11), batch(12)]
    u = np.maximum(np.random.RandomState(7).rand(WORLD * 6, TH, TW, NF),
                   np.finfo(np.float32).tiny).astype(np.float32)
    bad = {k: v.copy() for k, v in batch(13).items()}
    bad["hr"][1, 0, 0, 0] = np.nan
    out = tmp_path_factory.mktemp("train")
    root = str(out / "cvcp")
    make_synthetic_cvcp_tree(root, num_seqs=2, frames=10, h=32, w=32)
    ranks.spawn(ranks.train_rank, WORLD, weights, TRAIN_CFG, batches, u,
                bad, root, str(out))

    state = tstate.TrainState(ranks.tiny_model(weights, TRAIN_CFG, 0),
                              ranks.TrainConfig())
    assert not state.data_parallel
    losses = [tstate.train_step(state, b, gumbel_u=torch.from_numpy(u))
              .item() for b in batches]
    losses.append(tstate.train_step(state, batches[0],
                                    torch.Generator().manual_seed(5)).item())
    return load(str(out), "train"), state, losses


def test_data_parallel_steps_equal_one_process(trained):
    """Three updates (the injected draw twice, then the generator's),
    the NaN step skipped: both ranks hold the same parameters, within
    1e-5 relative of one process on the concatenated batches, and the
    same global losses."""
    results, state, losses = trained
    for got in results:
        assert got["data_parallel"] and got["steps"] == 3
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    one = state.model.state_dict()
    for name, p in one.items():
        assert torch.equal(results[0]["params"][name],
                           results[1]["params"][name]), name
        err = ((results[0]["params"][name] - p).norm()
               / p.norm().clamp_min(1e-30)).item()
        assert err <= 1e-5, (name, err)


def test_nan_on_one_rank_skips_the_update_on_both(trained):
    for got in trained[0]:
        guard = got["guard"]
        assert not np.isfinite(guard["loss"])
        assert guard["same"] and guard["step"] == 2 and guard["grads_cleared"]


def test_checkpoint_and_resume_under_two_ranks(trained):
    """``train_loop`` over two ranks: rank 0 writes one checkpoint an epoch
    and the log; a second run resumes on both ranks from the first's
    checkpoint, with its parameters, and trains the second epoch."""
    results = trained[0]
    for got in results:
        ck = got["ckpt"]
        assert ck["files_after_first"] == ["step_00000001.pt"]
        assert ck["files"] == ["step_00000001.pt", "step_00000002.pt"]
        assert ck["resumed_step"] == 1 and ck["final_step"] == 2
        assert len(ck["log"]) == 2
        for name, p in ck["saved"].items():
            assert torch.equal(ck["resumed"][name], p), name
            assert torch.equal(ck["final"][name],
                               results[0]["ckpt"]["final"][name]), name
    assert any(not torch.equal(results[0]["ckpt"]["final"][n], p)
               for n, p in results[0]["ckpt"]["saved"].items())


# -- single process and the CLIs -------------------------------------------------

def test_initialize_distributed_single_process(monkeypatch):
    """No launcher: a group of one, over gloo on the CPU; a second call is
    the first's; the card asked for without CUDA raises. The helpers over a
    group of one."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            initialize_distributed("cuda")
        with pytest.raises(RuntimeError):
            rank_device("cuda")
    try:
        assert initialize_distributed("cpu") == (0, 1)
        assert initialize_distributed("cpu") == (0, 1)
        assert torch.distributed.get_backend() == "gloo"
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(all_gather_rows(x), x)
        assert tstate.TrainState(ranks.tiny_model(
            None, dict(nf=16, scn_groups=1), 0), ranks.TrainConfig()) \
            .data_parallel
    finally:
        torch.distributed.destroy_process_group()
    assert list(shard_rows(list(range(6)), 1, 3)) == [2, 3]
    with pytest.raises(ValueError):
        shard_rows(list(range(5)), 0, 2)


def test_serve_cli_under_torchrun():
    """``torchrun --nproc-per-node 2 -m cdfo_tpu_torch.tools.serve --cpu``:
    rank 0 prints the JAX tool's JSON line, over two devices."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "cdfo_tpu_torch.tools.serve",
           "--cpu", "--fp32", "--frames", "4", "--height", "16", "--width",
           "24", "--k-per-device", "1"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1, proc.stdout
    assert lines[0]["devices"] == 2 and lines[0]["frames"] == 4
    assert lines[0]["mode"] == "sharded over 2 devices (k=2)"
    assert lines[0]["geometry"] == "16x24 -> 64x96" and lines[0]["fps"] > 0


@pytest.mark.parametrize("tool", ["serve", "dryrun", "train"])
def test_entry_points_need_the_card_or_cpu(tool):
    """Without CUDA and without ``--cpu`` each entry point exits non-zero
    before it starts."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    import importlib
    module = importlib.import_module(f"cdfo_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit) as exit_:
        module.main(["--distributed"] if tool == "train" else [])
    assert exit_.value.code not in (0, None)
