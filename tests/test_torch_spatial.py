"""The port's ``'spatial'`` mesh axis (``cdfo_tpu_torch/parallel/spatial.py``)
on CPU gloo ranks: CVSR_V8 with its frame rows split over ranks, against
``cdfo_tpu``'s single-device forward and the port's one-process paths.

One ``torch.multiprocessing`` spawn of four ranks
(``tests/torch_parallel_ranks.py::spatial_rank``) runs every split case:

- ``tests/test_parallel.py``'s spatial case: the float32 CVSR_V8 of its
  fixture (nf 64, ``scn_groups=1``, the expected mask) with ``cdfo_tpu``'s
  weights through ``from_flax``, one EGLA mask channel on, b 4 x 7 frames
  of 16x16 on a ``(2, 2)`` ``("data", "spatial")`` mesh; each rank's rows
  against ``cdfo_tpu``'s one-device ``model.apply`` within rtol = atol =
  2e-5;
- a ``(1, 4)`` mesh at H = 40 (16 / 8 / 8 / 8 rows: middle ranks with two
  neighbours, uneven shards), the plain model and the ablations the split
  runs, against the port's one-process forward within 2e-5;
- two sampled-mask ``train_step``s on the ``(2, 2)`` mesh with an injected
  global gumbel draw, against one process on the whole batch (losses, and
  each parameter within 1e-5 relative L2); ``tests/test_torch_train.py``
  holds that process against ``cdfo_tpu``.

Then the plain cases (the window-aligned split, the refusals) and the dry
run under ``torchrun`` on four CPU ranks.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.models import CVSRV8, build_model
from cdfo_tpu_torch.parallel import SpatialShard, sharded, split_rows
from cdfo_tpu_torch.parallel.spatial import ROADMAP_ITEM
from cdfo_tpu_torch.train import state as tstate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SMALL = dict(nf=16, scn_groups=1)
TRAIN = dict(nf=16, scn_groups=2, mask_mode="sample")
ABLATIONS = ("use_pab", "use_ga", "use_mv", "use_pd", "use_egla")
UNEVEN_H, UNEVEN_W = 40, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_inputs(b=4, n=7, h=16, w=16):
    """``tests/test_parallel.py``'s ``inputs``."""
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 6)
    return (jax.random.uniform(ks[0], (b, n, h, w, 1)),
            jax.random.normal(ks[1], (b, n, h, w, 2)) * 0.3,
            jax.random.normal(ks[2], (b, n, h, w, 2)) * 0.3,
            jax.random.uniform(ks[3], (b, n, h, w, 1)),
            jax.random.uniform(ks[4], (b, n, h, w, 1)) - 0.5,
            jax.random.uniform(ks[5], (b, n, h, w, 1)))


def as_batch(arrays) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in zip(tstate.MODEL_INPUTS, arrays)}


def window(b, h, w, seed) -> dict:
    r = np.random.RandomState(seed)
    lrs, pms, rms, ufs = (r.rand(b, 7, h, w, 1).astype(np.float32)
                          for _ in range(4))
    mvs = (r.randn(b, 7, h, w, 2) * 1.5).astype(np.float32)
    return {"lrs": lrs, "mvs0": mvs, "mvs1": mvs, "pms": pms, "rms": rms,
            "ufs": ufs}


def seeded_weights(cfg, seed, excite=True) -> dict:
    """A tiny model's weights, one EGLA mask channel on (else the mask is
    all zero and the long-range attention carries nothing)."""
    model = ranks.tiny_model(None, cfg, seed)
    if excite and hasattr(getattr(model, "RDAB", None), "conv_du_re2"):
        with torch.no_grad():
            model.RDAB.conv_du_re2[0].bias[3] += 10.0
    return {k: v.numpy() for k, v in model.state_dict().items()}


def train_batch(seed, rows=2, h=16, w=16) -> dict:
    batch = window(rows, h, w, seed)
    batch["hr"] = np.random.RandomState(seed + 100).rand(
        rows, 4 * h, 4 * w, 1).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_case():
    """``tests/test_parallel.py``'s fixture model and inputs, one EGLA mask
    channel on: (inputs, the port's weights, cdfo_tpu's one-device SR)."""
    jmodel = JCVSRV8(JModelConfig(scn_groups=1, mask_mode="expected"))
    args = jax_inputs()
    params = jax.tree.map(np.array,
                          jax.jit(jmodel.init)(jax.random.PRNGKey(1), *args))
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    sr, _ = jax.jit(jmodel.apply)(params, *args)
    weights = {k: v.numpy() for k, v in from_flax(params).items()}
    return as_batch(args), weights, np.asarray(sr)


@pytest.fixture(scope="module")
def spawned(jax_case, tmp_path_factory):
    """The four ranks' results of every split case, and the cases."""
    inputs, weights, _ = jax_case
    uneven = window(1, UNEVEN_H, UNEVEN_W, 3)
    cases = {"jax": ((2, 2), "forward", weights,
                     dict(scn_groups=1, mask_mode="expected"), inputs),
             "uneven": ((1, 4), "forward", seeded_weights(SMALL, 1), SMALL,
                        uneven)}
    for flag in ABLATIONS:
        cfg = dict(SMALL, **{flag: False})
        cases[flag] = ((1, 4), "forward", seeded_weights(cfg, 2), cfg, uneven)
    u = np.maximum(np.random.RandomState(7).rand(2 * 6, 16, 16, TRAIN["nf"]),
                   np.finfo(np.float32).tiny).astype(np.float32)
    cases["train"] = ((2, 2), "train", seeded_weights(TRAIN, 3), TRAIN,
                      ([train_batch(11), train_batch(12)], u))
    out = str(tmp_path_factory.mktemp("spatial"))
    ranks.spawn(ranks.spatial_rank, WORLD,
                [(name, *case) for name, case in cases.items()], out)
    results = [torch.load(os.path.join(out, f"spatial_rank{r}.pt"),
                          weights_only=False) for r in range(WORLD)]
    return results, cases


def rows_of(full: np.ndarray, got: dict, data_size: int) -> np.ndarray:
    """The rank's rows of a global output: its data share, its H rows."""
    per = full.shape[0] // data_size
    start, stop = got["bounds"]
    i = got["data_index"]
    return full[i * per:(i + 1) * per, start:stop]


def test_split_equals_cdfo_tpu_single_device(jax_case, spawned):
    """``tests/test_parallel.py::test_spatial_sharded_forward_equivalence``
    on the port: each rank of the (2, 2) mesh holds b 2 x 8 rows, and its
    SR rows equal cdfo_tpu's one-device forward's."""
    _, _, ref = jax_case
    results, _ = spawned
    seen = set()
    for got in (r["jax"] for r in results):
        sr = got["sr"].numpy()
        assert sr.shape == (2, 32, 64, 1)
        np.testing.assert_allclose(sr, rows_of(ref, got, 2), rtol=2e-5,
                                   atol=2e-5)
        seen.add((got["data_index"], got["bounds"]))
    assert seen == {(0, (0, 32)), (0, (32, 64)), (1, (0, 32)), (1, (32, 64))}


def one_process(weights, cfg, inputs):
    model = ranks.tiny_model(weights, cfg, 0)
    with torch.no_grad():
        return model(*(torch.from_numpy(inputs[k])
                       for k in tstate.MODEL_INPUTS))


@pytest.mark.parametrize("name", ["uneven", *ABLATIONS])
def test_uneven_split_with_middle_ranks(spawned, name):
    """(1, 4) at H = 40: 16 / 8 / 8 / 8 rows, the middle ranks exchanging
    halos both ways; the plain model and each ablation the split runs
    (``use_*=False``) equal the port's one-process forward, SR and the
    GCPI features."""
    results, cases = spawned
    _, _, weights, cfg, inputs = cases[name]
    sr, l1 = one_process(weights, cfg, inputs)
    bounds = [r[name]["bounds"] for r in results]
    assert bounds == [(0, 64), (64, 96), (96, 128), (128, 160)]
    for got in (r[name] for r in results):
        np.testing.assert_allclose(got["sr"].numpy(),
                                   rows_of(sr.numpy(), got, 1), rtol=2e-5,
                                   atol=2e-5)
        start, stop = (v // 4 for v in got["bounds"])
        np.testing.assert_allclose(got["l1"].numpy(),
                                   l1[:, :, start:stop].numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_split_train_steps_equal_one_process(spawned):
    """Two sampled-mask steps on the (2, 2) mesh: the global losses and
    every rank's parameters (all four equal) within 1e-5 of one process on
    the whole batch, the same global draw injected."""
    results, cases = spawned
    _, _, weights, cfg, (batches, u) = cases["train"]
    state = tstate.TrainState(ranks.tiny_model(weights, cfg, 0),
                              ranks.TrainConfig())
    losses = [tstate.train_step(state, b, gumbel_u=torch.from_numpy(u))
              .item() for b in batches]
    one = state.model.state_dict()
    for got in (r["train"] for r in results):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for name, p in one.items():
        mine = results[0]["train"]["params"][name]
        for got in results[1:]:
            assert torch.equal(got["train"]["params"][name], mine), name
        err = ((mine - p).norm() / p.norm().clamp_min(1e-30)).item()
        assert err <= 1e-5, (name, err)
    moved = [n for n, p in one.items()
             if not torch.equal(p, torch.from_numpy(weights[n]))]
    assert len(moved) > len(one) // 2


# -- no ranks ----------------------------------------------------------------------

@pytest.mark.parametrize("parts,rows", [
    (1, (272,)), (2, (136, 136)), (3, (96, 88, 88)), (4, (72, 72, 64, 64))])
def test_window_aligned_split(parts, rows):
    assert split_rows(272, parts) == rows
    assert all(r % 8 == 0 for r in rows)


def test_split_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="multiple of 8"):
        split_rows(270, 2)
    with pytest.raises(ValueError, match="not one for each"):
        split_rows(16, 4)
    assert split_rows(40, 4) == (16, 8, 8, 8)


def one_rank_shard(h=16):
    return SpatialShard(h, (h,))


@pytest.mark.parametrize("flags", [
    dict(fused_trunk=True), dict(fused_embed=True),
    dict(fused_trunk=True, fused_align=True), dict(fused_egla=True),
    dict(block_warp=True), dict(fused_trunk=True, trunk_int8=True),
    dict(scan_trunk=True), dict(name="cvsr_v8_wola"), dict(name="cvsr_v9"),
    dict(name="cvsr_v7"), dict(name="sidecvsr")])
def test_split_refuses_the_paths_it_has_no_split_for(flags):
    """Under a shard every kernel flag, the scan trunk, woLA and the other
    families raise, naming the ROADMAP item; nothing falls back."""
    cfg = ModelConfig(**{**SMALL, **flags})
    model = build_model(cfg.name, cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    inputs = window(1, 16, 16, 0)
    args = [torch.from_numpy(inputs[k]) for k in tstate.MODEL_INPUTS]
    if cfg.name == "sidecvsr":
        del args[1]
    with sharded(one_rank_shard()), pytest.raises(ValueError,
                                                  match=ROADMAP_ITEM):
        model(*args)


def test_split_refuses_the_streaming_stages():
    model = CVSRV8(ModelConfig(**SMALL), torch.Generator().manual_seed(0),
                   device="cpu")
    frame = torch.zeros(1, 16, 16, 1)
    with sharded(one_rank_shard()), pytest.raises(ValueError,
                                                  match=ROADMAP_ITEM):
        model.compensate_frames(frame, frame, frame, frame)


def test_a_group_of_one_is_the_unsplit_forward():
    """A shard of one rank runs every module's unsplit code: the forward
    equals the plain one bit for bit."""
    weights = seeded_weights(SMALL, 4)
    inputs = window(1, 16, 16, 5)
    model = ranks.tiny_model(weights, SMALL, 0)
    args = [torch.from_numpy(inputs[k]) for k in tstate.MODEL_INPUTS]
    with torch.no_grad():
        plain, _ = model(*args)
        with sharded(one_rank_shard()):
            split, _ = model(*args)
    assert torch.equal(plain, split)


def test_dryrun_under_torchrun_on_four_cpu_ranks():
    """``torchrun --nproc-per-node 4 -m cdfo_tpu_torch.tools.dryrun --cpu``
    lays the ranks out as ``__graft_entry__.py`` does: a (2, 2) mesh, H
    split 8 / 8."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "cdfo_tpu_torch.tools.dryrun",
           "--cpu"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("dryrun_multichip OK")]
    assert len(lines) == 1, proc.stdout
    assert "world=4 (cpu) mesh (2, 2) ('data', 'spatial'), H rows (8, 8)" \
        in lines[0]
