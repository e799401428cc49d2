"""The port's CVSR_V8 ablations against cdfo_tpu's, in float32 on the CPU.

The paper's ablation table (woPAB, woLA, woGA, woMV, woPd) and the model
without EGLA, each on one set of JAX-initialised weights (nf 16, one trunk
group, 16x24 frames; the EGLA mask made one-hot where the model has EGLA,
so that its long-range attention carries signal): the forward, with and
without the ``pre_l1`` cache, within 1e-4 of the reference's largest
value; the streaming engine against cdfo_tpu's engine within 1 LSB at
k = 1 and 4, unfused and with every kernel flag the ablation admits
(``fused_trunk`` and whichever of ``fused_embed``, ``fused_align``,
``fused_egla`` and ``block_warp`` its modules take; on the CPU the
kernels' plain versions); the launch pattern of ``compensate_frames`` and
``align_reconstruct`` on the CPU's plain versions (which of the attention,
MDTA, dual-MSA and warp paths each ablation calls); and two train steps of
woLA against ``cdfo_tpu.train.state.train_step``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.config import TrainConfig as JTrainConfig
from cdfo_tpu.infer.engine import BatchedStreamingEngine as JEngine
from cdfo_tpu.infer.pipeline import synthetic_sequence as j_synthetic
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu.train.state import create_train_state, train_step as j_step
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.config import TrainConfig
from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
from cdfo_tpu_torch.models import CVSRV8, build_model
from cdfo_tpu_torch.models.attention import EGLA
from cdfo_tpu_torch.ops import kernel_cases as kc
from cdfo_tpu_torch.train import state as tstate

NF, T, H, W = 16, 9, 16, 24
ABLATIONS = kc.ABLATIONS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed=0, b=1):
    r = np.random.RandomState(seed)
    lrs, pms, rms, ufs = (r.rand(b, 7, H, W, 1).astype(np.float32)
                          for _ in range(4))
    mvs = (r.randn(b, 7, H, W, 2) * 2).astype(np.float32)
    return lrs, mvs, mvs, pms, rms, ufs


@functools.lru_cache(maxsize=None)
def jax_model(name):
    """(JAX model, its params with the EGLA mask one-hot where it has the
    full EGLA)."""
    jm = JCVSRV8(JModelConfig(nf=NF, scn_groups=1, mask_mode="expected",
                              **ABLATIONS[name]))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *inputs())
    params = jax.tree.map(np.array, params)
    rdab = params["params"].get("RDAB", {})
    if "conv_du_re2_0" in rdab:
        rdab["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    return jm, params


def port_model(name, **flags):
    _, params = jax_model(name)
    model = CVSRV8(ModelConfig(nf=NF, scn_groups=1, **ABLATIONS[name],
                               **flags),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(from_flax(params))
    return model


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_forward_matches_jax(name):
    jm, params = jax_model(name)
    args = inputs(1)
    pre = np.random.RandomState(2).rand(1, 7, H, W, NF).astype(np.float32)
    model = port_model(name)
    for p in (None, pre):
        ref, l1 = jax.jit(jm.apply)(params, *args, pre_l1=p)
        with torch.no_grad():
            out, t_l1 = model(*map(torch.from_numpy, args),
                              pre_l1=None if p is None else
                              torch.from_numpy(p))
        ref = np.asarray(ref)
        assert np.abs(out.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
        assert np.abs(t_l1.numpy() - np.asarray(l1)).max() <= \
            1e-4 * np.abs(np.asarray(l1)).max()


@functools.lru_cache(maxsize=None)
def jax_engine_frames(name, k):
    jm, params = jax_model(name)
    return JEngine(jm, params, k=k).run_sequence(
        j_synthetic(t=T, h=H, w=W, seed=3))[0]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_engine_matches_jax_engine(name, k):
    ref = jax_engine_frames(name, k)
    data = synthetic_sequence(t=T, h=H, w=W, seed=3)
    for flags in ({}, kc.admitted_flags(ABLATIONS[name])):
        frames, _ = BatchedStreamingEngine(port_model(name, **flags),
                                           k=k).run_sequence(data)
        assert frames.shape == ref.shape == (T, 4 * H, 4 * W)
        diff = np.abs(frames.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1, (name, k, flags, diff.max())
        assert frames.std() > 0


def test_admitted_flags_follow_the_modules():
    """Each ablation takes the kernel flags whose modules it keeps."""
    got = {n: sorted(kc.admitted_flags(a)) for n, a in ABLATIONS.items()}
    every = set(kc.KERNEL_FLAGS)
    assert got == {
        "woPAB": sorted(every - {"fused_embed"}),
        "woLA": sorted(every - {"fused_egla"}),
        "woGA": sorted(every - {"fused_egla"}),
        "woMV": sorted(every - {"fused_align", "block_warp"}),
        "woPd": sorted(every - {"fused_align"}),
        "noEGLA": sorted(every - {"fused_egla"})}


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_calls(name, monkeypatch):
    """Which paths an engine step takes, counted on the CPU's plain
    versions: the EGLA attention, the MDTA rounds, the dual MSA and the
    warp, as the chip's launch table expects of each ablation."""
    import cdfo_tpu_torch.models.attention as attn
    import cdfo_tpu_torch.models.cvsr as cvsr
    import cdfo_tpu_torch.models.prior_encoder as pe
    calls = {"column": 0, "mdta1": 0, "msa1": 0, "warp": 0, "tail": 0}

    def counting(mod, fn_name, key):
        fn = getattr(mod, fn_name)

        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, fn_name, wrapped)

    import cdfo_tpu_torch.models.alignment as al
    counting(attn, "column_self_attention", "column")
    counting(pe, "mdta_stage1", "mdta1")
    counting(al, "msa_stage1", "msa1")
    counting(al, "resblock_pair", "tail")
    counting(cvsr, "flow_warp_ring", "warp")
    flags = kc.admitted_flags(ABLATIONS[name])
    flags.pop("block_warp", None)
    model = port_model(name, **flags)
    BatchedStreamingEngine(model, k=4).run_sequence(
        synthetic_sequence(t=4, h=H, w=W, seed=3))
    a = ABLATIONS[name]
    egla = a.get("use_la", True) and a.get("use_ga", True) and \
        a.get("use_egla", True)
    both = a.get("use_mv", True) and a.get("use_pd", True)
    # the bootstrap and one step: two compensate_frames, one align_reconstruct
    assert calls == {"column": 2 if egla else 0,
                     "mdta1": 6 if a.get("use_pab", True) else 0,
                     "msa1": 1 if both else 0,
                     "warp": 1 if a.get("use_mv", True) else 0,
                     "tail": 1}, (name, calls)
    assert isinstance(getattr(model, "RDAB", None), EGLA) == egla


def test_registry_names_switch_their_flag():
    for name, flag in (("cvsr_v8_wopab", "use_pab"),
                       ("cvsr_v8_wola", "use_la"),
                       ("cvsr_v8_woga", "use_ga"), ("cvsr_v8_womv", "use_mv"),
                       ("cvsr_v8_wopd", "use_pd")):
        model = build_model(name, ModelConfig(nf=NF, scn_groups=1),
                            device="cpu")
        assert not getattr(model.cfg, flag) and model.cfg.name == name
        keys = set(model.state_dict())
        assert ("conv_second.weight" in keys) == (flag != "use_pab")
        assert ("conv_expand_ufs.weight" in keys) == (flag != "use_pd")
        assert ("conv_expand_rms.weight" in keys) == (flag != "use_la")


# -- two train steps of woLA ------------------------------------------------------

TB = 1


def batch(seed):
    r = np.random.RandomState(seed)
    lrs, pms, rms, ufs = (r.rand(TB, 7, H, W, 1).astype(np.float32)
                          for _ in range(4))
    mvs = (r.randn(TB, 7, H, W, 2) * 1.5).astype(np.float32)
    return {"lrs": lrs, "mvs0": mvs, "mvs1": mvs, "pms": pms, "rms": rms,
            "ufs": ufs,
            "hr": r.rand(TB, 4 * H, 4 * W, 1).astype(np.float32)}


def test_wola_train_steps_match_cdfo_tpu():
    """woLA draws no mask noise, so the two trainers see the same
    function; the losses within 1e-4 relative, every parameter after the
    second Adam step within 1e-4 relative L2 (see test_torch_train)."""
    model = JCVSRV8(JModelConfig(nf=NF, scn_groups=1, use_la=False))
    b0, b1 = batch(1), batch(2)
    state = create_train_state(model, JTrainConfig(), b0)
    init = from_flax(jax.tree.map(np.asarray, state.params))
    step = jax.jit(j_step)
    state1, loss1 = step(state, b0, jax.random.PRNGKey(0))
    state2, loss2 = step(state1, b1, jax.random.PRNGKey(1))
    final = from_flax(jax.tree.map(np.asarray, state2.params))
    port = CVSRV8(ModelConfig(nf=NF, scn_groups=1, use_la=False,
                              mask_mode="sample"),
                  generator=torch.Generator().manual_seed(0), device="cpu")
    port.load_state_dict(init)
    ts = tstate.TrainState(port, TrainConfig())
    for b, ref in ((b0, loss1), (b1, loss2)):
        loss = float(tstate.train_step(ts, b))
        assert abs(loss - float(ref)) <= 1e-4 * abs(float(ref))
    sd = port.state_dict()
    for name, p in final.items():
        err = ((sd[name] - p).norm() / p.norm()).item()
        assert err <= 1e-4, (name, err)
