"""The port's fused embed and fused alignment (``ModelConfig(fused_embed=
True, fused_align=True)``) against cdfo_tpu's, in float32 on the CPU.

* Each plain PyTorch version (``mdta_stage1/2``, ``msa_stage1/2``,
  ``attention_matrix``) against the JAX Pallas kernel it ports, run as the
  JAX suite runs it on the CPU (interpret mode), at narrow widths (C = 16),
  ``rows=8`` and H = 16 so the TPU grid takes two steps, and a ragged W.
* ``PartitionTransformerSA2Fast`` and ``DualAttAlignment.fused_msa``
  against JAX's fused modules on weights carried over by ``from_flax``
  (``strict``), and the fused model's parameter tree.
* The port's engine with all three fused flags against the JAX engine
  (``fused_trunk=False``, which the JAX suite pins equal to its fused
  engine): uint8 frames within 1 LSB.
* The config's new refusal.

Inputs come from numpy seeds; kernels agree within 1e-4 of the reference's
largest magnitude (the JAX suite's rule), the modules within 2e-4 (the JAX
fused-module tests' bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.infer.engine import BatchedStreamingEngine as JEngine
from cdfo_tpu.infer.pipeline import synthetic_sequence as j_synthetic
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu.models.alignment import DualAttAlignment as JAlign
from cdfo_tpu.models.prior_encoder import PartitionTransformerSA2 as JGCPI
from cdfo_tpu.models.prior_encoder import \
    PartitionTransformerSA2Fast as JFastGCPI
from cdfo_tpu.ops import fused_align as jfa
from cdfo_tpu.ops import fused_mdta as jfm
from cdfo_tpu.ops.fused_block import dual_weights
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.models.alignment import DualAttAlignment
from cdfo_tpu_torch.models.prior_encoder import PartitionTransformerSA2Fast
from cdfo_tpu_torch.ops import fused_align as fal
from cdfo_tpu_torch.ops import fused_mdta as fm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C, ROWS = 16, 8


def assert_close(port, ref, rel=1e-4):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


def rand(r, *shape, scale=1.0):
    return (r.randn(*shape) * scale).astype(np.float32)


def hcw_pad(a, rows=ROWS, wt=128):
    """NHWC numpy -> the MDTA kernels' stage input (B, Hp + 2, C, wt + 128):
    rows padded to a multiple of ``rows``, one zero row each side, data at
    lane offset 2 (``PartitionTransformerSA2Fast``'s ``pad_hcw``)."""
    b, h, w, _ = a.shape
    t = np.transpose(a, (0, 1, 3, 2))
    t = np.pad(t, ((0, 0), (0, (-h) % rows), (0, 0), (0, wt - w)))
    return jnp.asarray(np.pad(t, ((0, 0), (1, 1), (0, 0), (2, 126))))


def nhwc(hcw, h, w):
    """The kernels' (B, H, C, W) -> NHWC, cut to the image."""
    return np.transpose(np.asarray(hcw)[:, :h, :, :w], (0, 1, 3, 2))


# -- the MDTA passes -------------------------------------------------------------

M, H, W = 2, 16, 20


def _mdta_case(seed):
    r = np.random.RandomState(seed)
    return dict(x=rand(r, M, H, W, C), x2=rand(r, M, H, W, C),
                v=rand(r, M, H, W, C), ln_w=1.0 + rand(r, C, scale=0.1),
                ln_b=rand(r, C, scale=0.1),
                w_qkv=rand(r, 3 * C, C, scale=0.25),
                taps=rand(r, 3 * C, 9, scale=0.3),
                amat=np.asarray(jax.nn.softmax(rand(r, M, C, C, scale=2.0))),
                w_proj=rand(r, C, C, scale=0.25),
                k_conv=rand(r, 3, 3, C, C, scale=0.08),
                b_conv=rand(r, C, scale=0.1))


def test_mdta_stage1_plain_matches_pallas_kernel():
    a = _mdta_case(0)
    v_ref, st_ref = jfm.mdta_stage1(
        hcw_pad(a["x"]), jnp.asarray(a["ln_w"])[:, None],
        jnp.asarray(a["ln_b"])[:, None], jnp.asarray(a["w_qkv"]),
        jnp.asarray(a["taps"]), img_h=H, img_w=W, rows=ROWS, wt=128)
    v, stats = fm.mdta_stage1_plain(
        t_(a["x"]), t_(a["ln_w"]), t_(a["ln_b"]), t_(a["w_qkv"])[..., None,
                                                               None],
        t_(a["taps"]).reshape(3 * C, 1, 3, 3))
    assert_close(v, nhwc(v_ref, H, W))
    assert_close(stats, st_ref)


def test_mdta_stage2_plain_matches_pallas_kernel():
    a = _mdta_case(1)
    x2 = np.pad(np.transpose(a["x2"], (0, 1, 3, 2)),
                ((0, 0), (0, 0), (0, 0), (0, 128 - W)))
    ref = jfm.mdta_stage2(
        hcw_pad(a["x"]), hcw_pad(a["v"]), jnp.asarray(x2),
        jnp.asarray(a["amat"]), jnp.asarray(a["w_proj"]),
        jnp.asarray(a["ln_w"])[:, None], jnp.asarray(a["ln_b"])[:, None],
        dual_weights(jnp.asarray(a["k_conv"])),
        jnp.asarray(a["b_conv"])[:, None], img_h=H, img_w=W, rows=ROWS,
        wt=128)
    out = fm.mdta_stage2_plain(
        t_(a["x"]), t_(a["v"]), t_(a["x2"]), t_(a["amat"]),
        t_(a["w_proj"])[..., None, None], t_(a["ln_w"]), t_(a["ln_b"]),
        t_(np.transpose(a["k_conv"], (3, 2, 0, 1))), t_(a["b_conv"]))
    assert_close(out, nhwc(ref, H, W))


@pytest.mark.parametrize("heads", [4, 8])
def test_attention_matrix_matches_jax(heads):
    r = np.random.RandomState(2)
    q, k = rand(r, 3, 50, C), rand(r, 3, 50, C)
    stats = np.stack([np.einsum("bpc,bpd->bcd", q, k),
                      np.einsum("bpc,bpd->bcd", q, q),
                      np.einsum("bpc,bpd->bcd", k, k)], axis=1)
    temp = 1.0 + rand(r, heads, 1, 1, scale=0.3)
    ref = jfm.attention_matrix(jnp.asarray(stats), jnp.asarray(temp), heads)
    assert_close(fm.attention_matrix(t_(stats), t_(temp), heads), ref)


# -- the dual-MSA passes ---------------------------------------------------------

BC, NBR = 2, 3


def _msa_case(seed):
    r = np.random.RandomState(seed)
    b = BC * NBR
    mats = [np.asarray(jax.nn.softmax(rand(r, b, C, C, scale=2.0)))
            * r.rand(b, C, 1).astype(np.float32) for _ in range(2)]
    return dict(w=rand(r, b, H, W, C), p=rand(r, b, H, W, C),
                q=rand(r, BC, H, W, C), wfuse=rand(r, 2 * C, C, scale=0.2),
                wproj=rand(r, C, C, scale=0.25), awt=mats[0], apt=mats[1])


def test_msa_stage1_plain_matches_pallas_kernel():
    a = _msa_case(3)
    ref = np.asarray(jfa.msa_stage1(
        jnp.asarray(a["w"]), jnp.asarray(a["p"]), jnp.asarray(a["q"]),
        jnp.asarray(a["wfuse"]), img_h=H, img_w=W, nbr=NBR, rows=ROWS))
    stats, gaps = fal.msa_stage1_plain(
        t_(a["w"]), t_(a["p"]), t_(a["q"]), t_(a["wfuse"].T)[..., None, None])
    assert_close(stats, ref[:, :3])
    # the TPU layout broadcasts each GAP row over a (C, C) block
    assert_close(gaps, ref[:, 3:5, 0, :])


def test_msa_stage2_plain_matches_pallas_kernel():
    a = _msa_case(4)
    fo_ref, st2 = jfa.msa_stage2(
        jnp.asarray(a["w"]), jnp.asarray(a["p"]), jnp.asarray(a["q"]),
        jnp.asarray(a["awt"]), jnp.asarray(a["apt"]), jnp.asarray(a["wproj"]),
        jnp.asarray(a["wfuse"]), img_h=H, img_w=W, nbr=NBR, rows=ROWS)
    fo, gap = fal.msa_stage2_plain(
        t_(a["w"]), t_(a["p"]), t_(a["q"]), t_(a["awt"]), t_(a["apt"]),
        t_(a["wproj"].T)[..., None, None], t_(a["wfuse"].T)[..., None, None])
    assert_close(fo, nhwc(fo_ref, H, W))
    assert_close(gap, np.asarray(st2)[:, 0, 0, :])


# -- the fused modules -------------------------------------------------------------

def test_fast_gcpi_matches_jax_fast_gcpi():
    r = np.random.RandomState(5)
    x1, x2 = rand(r, 1, H, W, C, scale=0.5), rand(r, 1, H, W, C, scale=0.5)
    jmod = JFastGCPI(C, 4)
    # the unfused module's tree is the fused one's (cdfo_tpu's own test),
    # and its init does not run the kernels in interpret mode
    params = jax.tree.map(np.array, JGCPI(C, 4).init(jax.random.PRNGKey(0),
                                                     x1, x2))
    params["params"]["attn"]["temperature"] += 0.5
    ref = jax.jit(jmod.apply)(params, x1, x2)
    tmod = PartitionTransformerSA2Fast(C, 4)
    tmod.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        out = tmod(t_(x1), t_(x2))
    assert_close(out, ref, rel=2e-4)


def test_fused_msa_matches_jax_fused_msa():
    r = np.random.RandomState(6)
    nbr = 2
    b = BC * nbr
    center = rand(r, BC, H, W, C, scale=0.5)
    warped, pred = rand(r, b, H, W, C, scale=0.5), rand(r, b, H, W, C,
                                                         scale=0.5)
    flow = np.zeros((b, H, W, 2), np.float32)
    rep = np.repeat(center, nbr, axis=0)
    jmod = JAlign(C, 4)
    params = jax.tree.map(np.array, jmod.init(
        jax.random.PRNGKey(0), rep, warped, pred, flow))
    params["params"]["msa"]["temperature"] += 0.5
    ref = jmod.apply(params, None, None, pred, flow, warped_feat=warped,
                     center_hcw=np.transpose(center, (0, 1, 3, 2)),
                     center_nhwc=center)
    tmod = DualAttAlignment(C, 4)
    tmod.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        out = tmod.fused_msa(t_(warped), t_(pred), t_(center))
    assert_close(out, np.transpose(np.asarray(ref), (0, 1, 3, 2)), rel=2e-4)


# -- the model and the engine --------------------------------------------------------

NF, T, HE, WE = 32, 9, 16, 24
FUSED = dict(fused_trunk=True, fused_embed=True, fused_align=True)


@pytest.fixture(scope="module")
def setup():
    """JAX weights of the unfused model (EGLA excited) in a port model with
    all three fused flags."""
    d = np.zeros((1, 7, HE, WE, 1), np.float32)
    dm = np.zeros((1, 7, HE, WE, 2), np.float32)
    jmodel = JCVSRV8(JModelConfig(nf=NF, scn_groups=2, mask_mode="expected"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), d, dm, dm, d, d, d)
    params = jax.tree.map(np.array, params)
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    tmodel = CVSRV8(ModelConfig(nf=NF, scn_groups=2, **FUSED),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    tmodel.load_state_dict(from_flax(params), strict=True)
    return jmodel, params, tmodel


def test_fused_weight_tree_is_the_unfused_one(setup):
    """cdfo_tpu's fused modules keep the unfused parameter tree, so
    ``from_flax`` of either loads strictly into the fused port model."""
    _, params, tmodel = setup
    d = np.zeros((1, 7, HE, WE, 1), np.float32)
    dm = np.zeros((1, 7, HE, WE, 2), np.float32)

    def tree(cfg):
        shapes = jax.eval_shape(JCVSRV8(cfg).init, jax.random.PRNGKey(0), d,
                                dm, dm, d, d, d)
        return jax.tree_util.tree_map(lambda s: (s.shape, s.dtype), shapes)

    base = dict(nf=NF, scn_groups=2, mask_mode="expected")
    assert tree(JModelConfig(**base)) == tree(JModelConfig(**base, **FUSED))
    assert set(tmodel.state_dict()) == set(from_flax(params))


@pytest.mark.parametrize("k", [1, 4])
def test_fused_engine_matches_jax_engine(setup, k):
    jmodel, params, tmodel = setup
    ref, _ = JEngine(jmodel, params, k=k).run_sequence(
        j_synthetic(t=T, h=HE, w=WE, seed=3))
    frames, _ = BatchedStreamingEngine(tmodel, k=k).run_sequence(
        synthetic_sequence(t=T, h=HE, w=WE, seed=3))
    assert frames.shape == ref.shape == (T, 4 * HE, 4 * WE)
    diff = np.abs(frames.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, (k, diff.max(), (diff > 1).sum())
    assert frames.std() > 0


def test_config_takes_the_fused_flags_and_refuses_align_alone():
    cfg = ModelConfig(compute_dtype=torch.bfloat16, **FUSED)
    assert cfg.fused_embed and cfg.fused_align
    assert ModelConfig(fused_embed=True).fused_embed
    with pytest.raises(ValueError, match="fused_trunk"):
        ModelConfig(fused_align=True)
    assert ModelConfig(block_warp=True, **FUSED).block_warp
    # cdfo_tpu ignores the scan trunk under the fused trunk
    with pytest.raises(ValueError, match="scan_trunk"):
        ModelConfig(scan_trunk=True, **FUSED)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CVSRV8(ModelConfig(nf=16, scn_groups=1),
               generator=torch.Generator().manual_seed(0))
