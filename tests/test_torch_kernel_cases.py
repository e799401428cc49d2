"""The rule that holds a kernel's outputs against its plain version's
(``cdfo_tpu_torch/ops/kernel_cases.py``): each slice of one scale against
its own largest value, so that a wrong small gram beside a large one is
caught."""
import numpy as np
import pytest
import torch

from cdfo_tpu_torch.ops import kernel_cases as kc


def _msa_stats(seed=0, b=2, c=64):
    """Stage-1 outputs with the main path's scales (272 x 480 pixels):
    q^T q diagonals ~1.3e5, q^T k entries ~3e2, GAP sums ~4e2."""
    rng = np.random.default_rng(seed)
    stats = rng.normal(0.0, 300.0, (b, 3, c, c))
    stats[:, 1] += np.eye(c) * 1.3e5
    stats[:, 2] = np.abs(stats[:, 2]) * 50.0
    gaps = rng.normal(0.0, 400.0, (b, 2, c))
    return (torch.tensor(stats, dtype=torch.float32),
            torch.tensor(gaps, dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_equal_and_slightly_off_outputs_pass(dtype):
    ref = _msa_stats()
    kc.assert_outputs_close(ref, ref, dtype, "msa1")
    # each slice off by a tenth of its tolerance
    off = tuple(r + 0.1 * kc.TOLERANCE[dtype] * r.abs().amax(
        dim=tuple(range(2, r.dim())), keepdim=True) for r in ref)
    kc.assert_outputs_close(off, ref, dtype, "msa1")


@pytest.mark.parametrize("fault", ["zeroed", "transposed", "scaled", "gap"])
def test_a_wrong_small_slice_is_caught(fault):
    """A q^T k gram that is zero, transposed or 5% off, or a GAP row 5%
    off, would pass against the largest entry of all the outputs (the q^T q
    diagonal) at the bfloat16 tolerance; held per slice it fails."""
    ref = _msa_stats()
    stats, gaps = (t.clone() for t in ref)
    if fault == "zeroed":
        stats[1, 0] = 0.0
    elif fault == "transposed":
        stats[1, 0] = ref[0][1, 0].t()
    elif fault == "scaled":
        stats[1, 0] *= 1.05
    else:
        gaps[0, 1] *= 1.05
    tol = kc.TOLERANCE[torch.bfloat16]
    whole = max((o - r).abs().max() for o, r in zip((stats, gaps), ref))
    assert whole <= tol * stats.abs().max()   # the fault hides at one scale
    err, scale = kc.worst_error((stats, gaps), ref, "msa1")
    assert err > tol * scale
    with pytest.raises(AssertionError):
        kc.assert_outputs_close((stats, gaps), ref, torch.bfloat16, "msa1")


def test_an_output_without_slices_is_held_whole():
    ref = torch.tensor([[1.0, 100.0], [1.0, 1.0]])
    out = ref.clone()
    out[1, 0] = 1.5   # half off in a small row, 0.5% of the largest value
    assert kc.worst_error(out, ref) == (0.5, 100.0)
    kc.assert_outputs_close(out, ref, torch.bfloat16, "block")
    with pytest.raises(AssertionError):
        kc.assert_outputs_close(out, ref, torch.bfloat16, "mdta2")


def _egla_outputs(kind, seed=1):
    """(args, plain outputs) of one EGLA kernel at a small seeded case."""
    from cdfo_tpu_torch.ops import fused_egla as fe
    g = torch.Generator().manual_seed(seed)
    args = kc.egla_args(kind, torch.float32, g, (2, 8, 24, 64), device="cpu")
    plain = fe.eg1_rows_plain if kind == "eg1" else fe.eg2_local_fuse_plain
    return args, plain(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_egla_outputs_pass_against_themselves(dtype):
    for kind in ("eg1", "eg2"):
        _, ref = _egla_outputs(kind)
        kc.assert_outputs_close(ref, ref, dtype, kind)


@pytest.mark.parametrize("fault", ["zeroed_qc", "one_frame_qc",
                                   "no_residual"])
def test_a_wrong_egla_output_is_caught(fault):
    """A zero q_c (what an all-zero mask or a lost q projection gives), a
    zero q_c in one frame only, and eg2's output without its residual x
    fail the check, at the bfloat16 tolerance."""
    kind = "eg2" if fault == "no_residual" else "eg1"
    args, ref = _egla_outputs(kind)
    if kind == "eg1":
        qc, vr = (t.clone() for t in ref)
        if fault == "zeroed_qc":
            qc.zero_()
        else:
            qc[1].zero_()
        out = (qc, vr)
    else:
        out = ref - args[0]
    with pytest.raises(AssertionError):
        kc.assert_outputs_close(out, ref, torch.bfloat16, kind)


def _blockq_outputs(margin=None):
    """The int8 Block_'s plain output at a small seeded case of five
    serial steps; with ``margin``, under another LAG_MARGIN."""
    from cdfo_tpu_torch.ops import fused_block2_q as fq
    g = torch.Generator().manual_seed(2)
    args = kc.trunk_args("blockq", torch.float32, g, (1, 40, 8, 16),
                         device="cpu")
    old = fq.LAG_MARGIN
    try:
        if margin is not None:
            fq.LAG_MARGIN = margin
        with torch.no_grad():
            return fq.scale_block_q_plain(*args)
    finally:
        fq.LAG_MARGIN = old


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_block_tolerance(dtype):
    """A tenth of cdfo_tpu's own int8-vs-exact bound in float32, the 4
    output ulps of every bfloat16 kernel in bfloat16; other kinds keep
    the common limits."""
    assert kc.tolerance(dtype, "blockq") == {torch.float32: 5e-3,
                                             torch.bfloat16: 1.6e-2}[dtype]
    assert kc.tolerance(dtype, "block") == kc.TOLERANCE[dtype]
    assert kc.tolerance(dtype) == kc.TOLERANCE[dtype]
    ref = _blockq_outputs()
    kc.assert_outputs_close(ref, ref, dtype, "blockq")


@pytest.mark.parametrize("fault", ["zeroed_lag", "no_margin_is_fine"])
def test_a_zeroed_lag_scale_is_caught(fault):
    """A kernel that lost its running amax (a zero lagged scale: every y
    of the steps after the first clips to +-127 times 1e-8 / 127) fails in
    both dtypes; the margin alone (1.0 for 1.25) moves a few values by a
    quantization step and stays inside the bfloat16 limit."""
    ref = _blockq_outputs()
    if fault == "zeroed_lag":
        out = _blockq_outputs(margin=0.0)
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(AssertionError):
                kc.assert_outputs_close(out, ref, dtype, "blockq")
    else:
        out = _blockq_outputs(margin=1.0)
        assert (out != ref).any()
        kc.assert_outputs_close(out, ref, torch.bfloat16, "blockq")


def test_a_warp_that_ignores_the_keep_mask_is_caught():
    """A warp whose out-of-range taps read the clamped edge pixel and
    whose keep mask is lost (what the TPU layout's clipped patch starts
    would give without their masks) differs wherever a block hangs over
    the frame; the kernel cases hold such blocks (a partly valid corner
    and bottom block, one fully outside), so the check fails."""
    from cdfo_tpu_torch.ops import warp_block as wb
    pad = torch.nn.functional.pad
    g = torch.Generator().manual_seed(0)
    ring, idx, flow = kc.warp_args("blocky", torch.float32, g, (3, 2, 16, 32),
                                   device="cpu")
    with torch.no_grad():
        ref = wb.flow_warp_ring_block_plain(ring, idx, flow)
        kc.assert_outputs_close(ref, ref, torch.bfloat16, "warp_blocky")
        # the same warp on a ring whose border repeats the edge: every tap
        # of the frame's samples is then in range and every keep bit on
        edge = pad(ring.permute(0, 3, 1, 2), (60, 60, 60, 60),
                   mode="replicate").permute(0, 2, 3, 1).contiguous()
        wide = pad(flow.permute(0, 3, 1, 2), (60, 60, 60, 60),
                   mode="replicate").permute(0, 2, 3, 1).contiguous()
        out = wb.flow_warp_ring_block_plain(edge, idx, wide)[:, 60:-60,
                                                             60:-60]
    # samples that stay inside the frame are untouched
    assert ((out - ref).abs() <= 2e-5).float().mean().item() > 0.5
    with pytest.raises(AssertionError):
        kc.assert_outputs_close(out, ref, torch.bfloat16, "warp_blocky")
