"""The port's deformable alignments and coding-prior encoders that no
registry model builds, against ``cdfo_tpu``'s in float32 on the CPU: the
``DPConv``, ``MVDeformableAlignment``, ``MVSelfAttDeformableAlignment``,
``MVIterativeDeformableAlignment`` (with and without a carried offset
feature), ``DeformableSKConv`` and ``STDF`` on the plain
``deform_conv2d``; the side encoders ``SideToFeaOne`` / ``SideToFeaUD`` /
``SideToFeaUDK``, ``TransformerBlockSimple`` and the four- and three-round
``PartitionTransformerSA`` / ``SA1``. nf 16 at 16x24, every zero-initialised
weight refilled (``torch_library_common``), tolerance 1e-4 of the
reference's largest value.
"""
import jax
import pytest
import torch

from cdfo_tpu.models import alignment_dcn as jad
from cdfo_tpu.models import layers as jlayers
from cdfo_tpu.models import prior_encoder as jpe
from cdfo_tpu_torch.models import alignment_dcn as tad
from cdfo_tpu_torch.models import layers as tlayers
from cdfo_tpu_torch.models import prior_encoder as tpe
from torch_library_common import assert_close, jax_params, load, rand, run

NF, H, W = 16, 16, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check(jm, port, *args, what="", **kw):
    """``port`` (loaded from ``jm``'s refilled params) equals ``jm`` on
    ``args``; returns the params."""
    params = jax_params(jm, *args, **kw)
    ref = jax.jit(jm.apply)(params, *args)
    out = run(load(port, params), *args)
    if isinstance(ref, tuple):
        for o, r in zip(out, ref):
            assert_close(o, r, what=what)
    else:
        assert_close(out, ref, what=what)
    return params


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 2)])
def test_dpconv_matches_cdfo_tpu(k, stride):
    x = rand(2, H, W, NF)
    check(jlayers.DPConv(24, k, stride), tlayers.DPConv(NF, 24, k, stride),
          x)


def _aligner_inputs():
    x, extra, pred = (rand(2, H, W, NF, seed=s) for s in range(3))
    return x, extra, pred, rand(2, H, W, 2, seed=3, scale=3.0)


def test_mv_deformable_alignment_matches_cdfo_tpu():
    x, extra, _, flow = _aligner_inputs()
    params = check(jad.MVDeformableAlignment(NF),
                   tad.MVDeformableAlignment(NF), x, extra, flow)
    assert params["params"]["conv_offset_6"]["conv"]["kernel"].any()


def test_mv_self_att_deformable_alignment_matches_cdfo_tpu():
    x, extra, pred, flow = _aligner_inputs()
    check(jad.MVSelfAttDeformableAlignment(NF),
          tad.MVSelfAttDeformableAlignment(NF), x, extra, pred, flow)


@pytest.mark.parametrize("carried", [False, True])
def test_mv_iterative_deformable_alignment_matches_cdfo_tpu(carried):
    """Both heads' inputs; the JAX tree holds ``scaleing`` and ``off2flow``
    only when it was built with a carried offset feature, so the port's
    first call takes that tree with those two refilled copies dropped."""
    x, extra, _, flow = _aligner_inputs()
    pre = rand(2, H, W, NF, seed=7)
    jm = jad.MVIterativeDeformableAlignment(NF)
    params = jax_params(jm, x, extra, flow, pre)
    port = load(tad.MVIterativeDeformableAlignment(NF), params)
    args = (x, extra, flow, pre) if carried else (x, extra, flow)
    ref = jax.jit(jm.apply)(params, *args)
    out = run(port, *args)
    assert_close(out[0], ref[0], what="aligned")
    assert_close(out[1], ref[1], what="offset feature")


def test_deformable_sk_conv_matches_cdfo_tpu():
    fea, inputs = rand(2, H, W, NF), rand(2, H, W, NF, seed=1)
    mv = rand(2, H, W, 2, seed=2, scale=2.0)
    params = check(jad.DeformableSKConv(NF, NF, 8),
                   tad.DeformableSKConv(NF, NF, 8), fea, inputs, mv)
    for i in range(3):
        assert params["params"][f"deform_bias_{i}"].any()


def test_stdf_matches_cdfo_tpu():
    x, extra, pred, mv = _aligner_inputs()
    check(jad.STDF(8, NF, NF, num_heads=4), tad.STDF(8, NF, NF, num_heads=4),
          x, extra, pred, mv)


@pytest.mark.parametrize("name", ["one", "ud", "udk"])
def test_side_encoders_match_cdfo_tpu(name):
    if name == "one":
        jm, port, c = jpe.SideToFeaOne(NF), tpe.SideToFeaOne(1, NF), 1
    elif name == "ud":
        jm, port, c = jpe.SideToFeaUD(NF), tpe.SideToFeaUD(NF), 1
    else:
        jm, port, c = jpe.SideToFeaUDK(NF, 8), tpe.SideToFeaUDK(NF, 8), NF
    check(jm, port, rand(2, H, W, c), what=name)


def test_transformer_block_simple_matches_cdfo_tpu():
    check(jpe.TransformerBlockSimple(NF, 4), tpe.TransformerBlockSimple(NF, 4),
          rand(2, H, W, NF))


@pytest.mark.parametrize("rounds", [4, 3])
def test_partition_transformer_sa_matches_cdfo_tpu(rounds):
    jcls, tcls = ((jpe.PartitionTransformerSA, tpe.PartitionTransformerSA)
                  if rounds == 4 else
                  (jpe.PartitionTransformerSA1, tpe.PartitionTransformerSA1))
    check(jcls(NF, 4), tcls(NF, 4), rand(2, H, W, NF),
          rand(2, H, W, NF, seed=1), what=str(rounds))
