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
