"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. A CUDA kernel has no interpret mode, so these tests skip where
no CUDA device exists. On a GPU machine (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses
import functools

import pytest
import torch

from cdfo_tpu_torch.ops import fused_attention as fa
from cdfo_tpu_torch.ops import fused_align as fal
from cdfo_tpu_torch.ops import fused_block2 as fb
from cdfo_tpu_torch.ops import fused_block2_q as fq
from cdfo_tpu_torch.ops import fused_egla as fe
from cdfo_tpu_torch.ops import fused_groupconv as fg
from cdfo_tpu_torch.ops import fused_head as fh
from cdfo_tpu_torch.ops import fused_mdta as fm
from cdfo_tpu_torch.ops import fused_tail as ft
from cdfo_tpu_torch.ops import fused_vjp as fv
from cdfo_tpu_torch.ops import kernel_cases as kc
from cdfo_tpu_torch.ops import warp_block as wb
from cdfo_tpu_torch.ops.kernel_cases import TOLERANCE
from cdfo_tpu_torch.tools import microbench_dots as mbd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape", [
    ("token", (5, 64, 64)), ("token", (3, 130, 64)), ("token", (2, 1, 64)),
    ("column", (2, 70, 9, 64)), ("column", (1, 16, 24, 64))])
def test_kernel_matches_plain(cuda, dtype, kind, shape):
    kernel, plain = {
        "token": (fa.token_self_attention, fa.token_attention_plain),
        "column": (fa.column_self_attention, fa.column_attention_plain),
    }[kind]
    g = torch.Generator(device=cuda).manual_seed(1)
    q = (torch.randn(shape, generator=g, device=cuda) * 0.35).to(dtype)
    v = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = kernel.launches
    out = kernel(q, v)
    ref = plain(q, v)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOLERANCE[dtype] * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("column", (4, 272, 480, 64)), ("token", (1088, 480, 64)),
    *[("token", (3, n, 64)) for n in (1, 16, 17, 63, 65, 273, 520)],
    *[("column", (2, n, 5, 64)) for n in (1, 16, 17, 63, 65, 273)]])
def test_bf16_attention_matches_plain(cuda, kind, shape):
    """The tensor-core route at the main path's column and row shapes and
    at N around the 16-row strips and 64-key groups (520: past the 512
    positions kept resident)."""
    kernel, plain = {
        "token": (fa.token_self_attention, fa.token_attention_plain),
        "column": (fa.column_self_attention, fa.column_attention_plain),
    }[kind]
    g = torch.Generator(device=cuda).manual_seed(3)
    q, v = kc.attention_args(torch.bfloat16, g, shape, device=cuda)
    before = kernel.launches
    with torch.no_grad():
        out = kernel(q, v)
        ref = plain(q, v)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    kc.assert_outputs_close(out, ref, torch.bfloat16, kind)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="64 channels"):
        fa.token_self_attention(q, q)
    q = torch.zeros(2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.token_self_attention(q, q)
    q = torch.zeros(8, 2, 64, device=cuda).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.token_self_attention(q, q)


# -- the fused-trunk kernels (Block_, group tail, head, alignment tail) ------

TRUNK = {
    "block": (fb.scale_block, fb.scale_block_plain),
    "group": (fg.grouptail, fg.grouptail_plain),
    "head": (fh.fused_head, fh.fused_head_plain),
    "tail": (ft.resblock_pair, ft.resblock_pair_plain),
}


def _trunk_case(kind, shape, dtype, device, seed=2):
    """(wrapper, plain, args) for one fused-trunk kernel at NHWC ``shape``
    (the tail gets 3 neighbours per image of ``shape``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (*TRUNK[kind], kc.trunk_args(kind, dtype, g, shape, nbr=3,
                                        device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 24, 64), (2, 18, 34, 64),
                                   (1, 10, 6, 64)])
@pytest.mark.parametrize("kind", ["block", "group", "head", "tail"])
def test_trunk_kernel_matches_plain(cuda, kind, shape, dtype):
    torch.backends.cudnn.allow_tf32 = False
    kernel, plain, args = _trunk_case(kind, shape, dtype, cuda)
    before = kernel.launches
    with torch.no_grad():
        out = kernel(*args)
        ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.dtype == ref.dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOLERANCE[dtype] * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_at_a_ragged_even_shape(cuda, dtype):
    """34 x 46: neither extent a multiple of the 8 x 8 tile, each 0.5x
    extent odd."""
    torch.backends.cudnn.allow_tf32 = False
    kernel, plain, args = _trunk_case("block", (1, 34, 46, 64), dtype, cuda)
    before = kernel.launches
    with torch.no_grad():
        out = kernel(*args)
        ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    kc.assert_outputs_close(out, ref, dtype, "block")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,nbr", [((1, 12, 54, 64), 3), ((1, 70, 100, 64), 3),
                                       ((2, 8, 24, 64), 1), ((1, 5, 26, 64), 2)])
def test_tail_walk_matches_plain(cuda, shape, nbr):
    """The bfloat16 tail's walk: 24-column strips of 8-row steps, ragged in
    both; 135 steps of 3 neighbours over the card's SMs, so that runs start
    inside strips; a single step; an image shorter than a step."""
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(6)
    args = kc.trunk_args("tail", torch.bfloat16, g, shape, nbr=nbr,
                         device=cuda)
    before = ft.resblock_pair.launches
    with torch.no_grad():
        packed = ft.pack_tail_weights(args[3::2], args[4::2], torch.bfloat16)
        out = ft.resblock_pair(*args)
        kept = ft.resblock_pair(*args, packed=packed)
        ref = ft.resblock_pair_plain(*args)
    torch.cuda.synchronize()
    assert ft.resblock_pair.launches == before + 2
    assert torch.equal(out, kept)
    kc.assert_outputs_close(out, ref, torch.bfloat16, "tail")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("head", (2, 40, 127, 64)), ("head", (1, 300, 127, 64)),
    ("mdta1", (1, 40, 127)), ("mdta1", (3, 33, 127)), ("mdta1", (1, 300, 127)),
    ("group", (2, 40, 127, 64)), ("group", (1, 300, 127, 64)),
    ("group", (3, 33, 127, 64)),
    ("mdta2", (1, 40, 127)), ("mdta2", (3, 33, 127)), ("mdta2", (1, 300, 127))])
def test_strip_walk_matches_plain(cuda, kind, shape):
    """The bfloat16 walks down 62-column strips, the last 3 columns wide:
    the head's and MDTA stage 1's a row a step, the group tail's and MDTA
    stage 2's two rows a step (odd row counts: a walk's last step drops a
    row), split over the card's SMs so that walks start and end inside
    strips (one row each, or several across a strip or image boundary);
    the pack kept gives the same result."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(7)
    if kind == "head":
        wrapper, plain = fh.fused_head, fh.fused_head_plain
        args = kc.trunk_args(kind, torch.bfloat16, g, shape, device=cuda)
        packed = fh.pack_head_weights(*args[2:7], torch.bfloat16)
    elif kind == "group":
        wrapper, plain = fg.grouptail, fg.grouptail_plain
        args = kc.trunk_args(kind, torch.bfloat16, g, shape, device=cuda)
        packed = fg.pack_grouptail_weights(args[2], torch.bfloat16)
    elif kind == "mdta1":
        wrapper, plain = fm.mdta_stage1, fm.mdta_stage1_plain
        args = kc.align_embed_args(kind, torch.bfloat16, g, shape, 3,
                                   device=cuda)
        packed = fm.pack_stage1_weights(args[3], args[4], torch.bfloat16)
    else:
        wrapper, plain = fm.mdta_stage2, fm.mdta_stage2_plain
        args = kc.align_embed_args(kind, torch.bfloat16, g, shape, 3,
                                   device=cuda)
        packed = fm.pack_stage2_weights(args[4], args[7], torch.bfloat16)
    before = wrapper.launches
    with torch.no_grad():
        out = wrapper(*args)
        kept = wrapper(*args, packed=packed)
        ref = plain(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    for o, k in zip(*(t if isinstance(t, tuple) else (t,) for t in (out, kept))):
        assert torch.equal(o, k)
    kc.assert_outputs_close(out, ref, torch.bfloat16, kind)


@pytest.mark.cuda
def test_models_cache_head_and_stage1_packs(cuda):
    """CVSRV8 keeps the head's pack and PartitionTransformerSA2Fast MDTA
    stage 1's until a parameter changes."""
    from cdfo_tpu_torch.config import ModelConfig
    from cdfo_tpu_torch.models.cvsr import CVSRV8
    from cdfo_tpu_torch.models.layers import init_weights
    from cdfo_tpu_torch.models.prior_encoder import PartitionTransformerSA2Fast
    cfg = ModelConfig(fused_trunk=True, compute_dtype=torch.bfloat16)
    model = CVSRV8(cfg, torch.Generator().manual_seed(0), device=cuda)
    t = torch.randn(1, 8, 16, 64, device=cuda).bfloat16()
    lr = torch.rand(1, 8, 16, 1, device=cuda)
    with torch.no_grad():
        a = model.head_from_trunk(t, lr)
        pack = model._head_pack
        assert torch.equal(a, model.head_from_trunk(t, lr))
        assert model._head_pack is pack
        model.upconv2.weight.mul_(0.5)
        model.head_from_trunk(t, lr)
    assert model._head_pack is not pack
    embed = init_weights(PartitionTransformerSA2Fast(64, dtype=torch.bfloat16),
                         torch.Generator().manual_seed(1)).to(cuda)
    x1 = torch.randn(1, 8, 16, 64, device=cuda).bfloat16()
    x2 = torch.randn(1, 8, 16, 64, device=cuda).bfloat16()
    with torch.no_grad():
        a = embed(x1, x2)
        pack = embed._stage1_pack
        assert torch.equal(a, embed(x1, x2)) and embed._stage1_pack is pack
        embed.attn.qkv.weight.mul_(0.5)
        embed(x1, x2)
    assert embed._stage1_pack is not pack


@pytest.mark.cuda
def test_models_cache_group_tail_and_stage2_packs(cuda):
    """SCNetFast's groups keep their tail's pack and
    PartitionTransformerSA2Fast MDTA stage 2's until a parameter
    changes."""
    from cdfo_tpu_torch.models.layers import init_weights
    from cdfo_tpu_torch.models.prior_encoder import PartitionTransformerSA2Fast
    from cdfo_tpu_torch.models.trunk_fast import SCNetFast
    trunk = init_weights(SCNetFast(64, num_groups=1, dtype=torch.bfloat16),
                         torch.Generator().manual_seed(2)).to(cuda)
    group = trunk.body[0]
    x = torch.randn(1, 8, 16, 64, device=cuda).bfloat16()
    with torch.no_grad():
        a = trunk(x)
        pack = group._pack
        assert torch.equal(a, trunk(x)) and group._pack is pack
        group.conv.weight.mul_(0.5)
        trunk(x)
    assert group._pack is not pack
    embed = init_weights(PartitionTransformerSA2Fast(64, dtype=torch.bfloat16),
                         torch.Generator().manual_seed(3)).to(cuda)
    x1 = torch.randn(1, 8, 16, 64, device=cuda).bfloat16()
    x2 = torch.randn(1, 8, 16, 64, device=cuda).bfloat16()
    with torch.no_grad():
        a = embed(x1, x2)
        pack = embed._stage2_pack
        assert torch.equal(a, embed(x1, x2)) and embed._stage2_pack is pack
        embed.attn.project_out.weight.mul_(0.5)
        embed(x1, x2)
        pack2 = embed._stage2_pack
        assert pack2 is not pack
        embed.conv.weight.mul_(0.5)
        embed(x1, x2)
    assert embed._stage2_pack is not pack2


@pytest.mark.cuda
def test_alignment_caches_its_tail_pack(cuda):
    from cdfo_tpu_torch.models.alignment import DualAttAlignment
    from cdfo_tpu_torch.models.layers import init_weights
    align = init_weights(DualAttAlignment(64), torch.Generator().manual_seed(0)
                         ).to(cuda).bfloat16()
    x = torch.randn(3, 8, 16, 64, device=cuda).bfloat16()
    center = torch.randn(1, 8, 16, 64, device=cuda).bfloat16()
    gate = torch.rand(3, 64, device=cuda).bfloat16()
    with torch.no_grad():
        a = align._tail(x, center, gate)
        pack = align._tail_pack
        b = align._tail(x, center, gate)
        assert align._tail_pack is pack and torch.equal(a, b)
        align.ResidualBlock.conv1.weight.mul_(0.5)
        align._tail(x, center, gate)
    assert align._tail_pack is not pack


@pytest.mark.cuda
def test_fused_trunk_built_under_inference_mode(cuda):
    """Parameters made under inference_mode keep no version counter; the
    fused Block_ then packs its weights at every call instead of caching."""
    from cdfo_tpu_torch.models.layers import init_weights
    from cdfo_tpu_torch.models.trunk import SCNetS
    from cdfo_tpu_torch.models.trunk_fast import SCNetFast
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        ref = init_weights(SCNetS(64, 1), torch.Generator().manual_seed(0))
        fast = SCNetFast(64, 1)
        fast.load_state_dict(ref.state_dict())
        ref.to(cuda)
        fast.to(cuda)
        x = torch.randn(1, 8, 12, 64, device=cuda)
        out, want = fast(x), ref(x)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    assert err <= TOLERANCE[torch.float32] * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["block", "group", "head", "tail"])
def test_trunk_kernel_rejects_what_it_does_not_take(cuda, kind):
    kernel, _, args = _trunk_case(kind, (1, 8, 8, 64), torch.float32, cuda)
    with torch.no_grad():
        narrow = _trunk_case(kind, (1, 8, 8, 32), torch.float32, cuda)[2]
        with pytest.raises(ValueError, match="64 channels"):
            kernel(*narrow)
        with pytest.raises(TypeError):
            kernel(*(a.half() for a in args))
        with pytest.raises(ValueError, match="contiguous"):
            kernel(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                   *args[1:])
        if kind == "block":
            odd = _trunk_case(kind, (1, 8, 7, 64), torch.float32, cuda)[2]
            with pytest.raises(ValueError, match="even"):
                kernel(*odd)


# -- the fused embed and alignment kernels (MDTA and dual-MSA passes) ---------

ALIGN_EMBED = {
    "mdta1": (fm.mdta_stage1, fm.mdta_stage1_plain),
    "mdta2": (fm.mdta_stage2, fm.mdta_stage2_plain),
    "msa1": (fal.msa_stage1, fal.msa_stage1_plain),
    "msa2": (fal.msa_stage2, fal.msa_stage2_plain),
}
# the position of the MDTA passes' LayerNorm weight among their arguments
NORM_ARG = {"mdta1": 1, "mdta2": 5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,nbr", [((2, 18, 34), 3), ((1, 16, 24), 6),
                                       ((1, 7, 5), 2)])
@pytest.mark.parametrize("kind", list(ALIGN_EMBED))
def test_align_embed_kernel_matches_plain(cuda, kind, shape, nbr, dtype):
    """``shape``: the MDTA images, or the centres of ``nbr`` neighbours
    each; the last is smaller than one tile."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, plain = ALIGN_EMBED[kind]
    g = torch.Generator(device=cuda).manual_seed(4)
    args = kc.align_embed_args(kind, dtype, g, shape, nbr, device=cuda)
    before = kernel.launches
    with torch.no_grad():
        out = kernel(*args)
        ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    kc.assert_outputs_close(out, ref, dtype, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,nbr", [((4, 272, 480), 6), ((4, 272, 480), 3),
                                       ((3, 10, 19), 3), ((5, 9, 200), 1)])
def test_msa2_walk_matches_plain(cuda, shape, nbr):
    """The bfloat16 stage-2 walk at the main path's shape with 6 and 3
    neighbours a centre, at a ragged one whose units a CTA walks across a
    centre, and at one neighbour a centre; the weights packed once (as the
    model keeps them) give the same bits as packed in the call."""
    g = torch.Generator(device=cuda).manual_seed(4)
    args = kc.align_embed_args("msa2", torch.bfloat16, g, shape, nbr,
                               device=cuda)
    packed = fal.pack_stage2_weights(args[5], args[6], torch.bfloat16)
    with torch.no_grad():
        out = fal.msa_stage2(*args)
        kept = fal.msa_stage2(*args, packed=packed)
        ref = fal.msa_stage2_plain(*args)
    torch.cuda.synchronize()
    kc.assert_outputs_close(out, ref, torch.bfloat16, "msa2")
    assert all(torch.equal(a, b) for a, b in zip(out, kept))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,nbr", [((4, 272, 480), 6), ((4, 272, 480), 3),
                                       ((3, 40, 100), 6), ((2, 18, 34), 3),
                                       ((4, 64, 100), 1), ((1, 7, 5), 2)])
def test_msa1_walk_matches_plain(cuda, shape, nbr):
    """The bfloat16 stage-1 walk (groups of nbr CTAs, rank f taking
    neighbour f) at the main path's shape with 6 and 3 neighbours a centre,
    at ragged pixel counts (not a multiple of the 128-pixel unit) whose
    groups' shares cross a centre, at one neighbour a centre (shares of 1.5
    units) and below one unit; a second call gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(4)
    args = kc.align_embed_args("msa1", torch.bfloat16, g, shape, nbr,
                               device=cuda)
    with torch.no_grad():
        out = fal.msa_stage1(*args)
        again = fal.msa_stage1(*args)
        ref = fal.msa_stage1_plain(*args)
    torch.cuda.synchronize()
    kc.assert_outputs_close(out, ref, torch.bfloat16, "msa1")
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
def test_alignment_caches_its_stage2_pack(cuda):
    """DualAttAlignment.fused_msa keeps stage 2's pack until W_proj or
    W_fuse changes."""
    from cdfo_tpu_torch.models.alignment import DualAttAlignment
    from cdfo_tpu_torch.models.layers import init_weights
    align = init_weights(DualAttAlignment(64, dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0)).to(cuda)
    w, p = (torch.randn(3, 8, 16, 64, device=cuda).bfloat16()
            for _ in range(2))
    center = torch.randn(1, 8, 16, 64, device=cuda).bfloat16()
    with torch.no_grad():
        a = align.fused_msa(w, p, center)
        pack = align._msa2_pack
        assert torch.equal(a, align.fused_msa(w, p, center))
        assert align._msa2_pack is pack
        align.project_out.weight.mul_(0.5)
        align.fused_msa(w, p, center)
        pack2 = align._msa2_pack
        assert pack2 is not pack
        align.fusion_out[0].weight.mul_(0.5)
        align.fused_msa(w, p, center)
    assert align._msa2_pack is not pack2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ALIGN_EMBED))
def test_align_embed_kernel_rejects_what_it_does_not_take(cuda, kind):
    kernel, _ = ALIGN_EMBED[kind]
    g = torch.Generator(device=cuda).manual_seed(5)
    x, *rest = kc.align_embed_args(kind, torch.float32, g, (1, 8, 8), 2,
                                   device=cuda)
    before = kernel.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="64 channels"):
            kernel(x[..., :32].contiguous(), *rest)
        with pytest.raises(TypeError):
            kernel(x.bfloat16(), *rest)
        with pytest.raises(ValueError, match="contiguous"):
            kernel(x.transpose(1, 2).contiguous().transpose(1, 2), *rest)
        if kind in NORM_ARG:   # a float32 norm parameter in another dtype
            bad = [x, *rest]
            bad[NORM_ARG[kind]] = bad[NORM_ARG[kind]].bfloat16()
            with pytest.raises(TypeError, match="float32"):
                kernel(*bad)
    with pytest.raises(NotImplementedError, match="no backward"):
        kernel(x.clone().requires_grad_(), *rest)
    assert kernel.launches == before


# -- the fused EGLA kernels (eg1 rows, eg2 windows) ------------------------------

EGLA = {"eg1": (fe.eg1_rows, fe.eg1_rows_plain),
        "eg2": (fe.eg2_local_fuse, fe.eg2_local_fuse_plain)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 272, 480, 64), (2, 24, 40, 64),
                                   (1, 8, 8, 64), (3, 16, 136, 64),
                                   (1, 16, 296, 64), (1, 8, 640, 64),
                                   (1, 8, 704, 64)])
@pytest.mark.parametrize("kind", list(EGLA))
def test_egla_kernel_matches_plain(cuda, kind, shape, dtype):
    """The main path's shape, a ragged W (not a multiple of the 64-key or
    128-query tile; eg2: a last tile of one window), one window, a row of
    three query tiles, a W past 256 off the 64-position tiles, the widest
    row eg1 keeps resident (640) and one past it (its first design's row
    pass, in two passes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, plain = EGLA[kind]
    g = torch.Generator(device=cuda).manual_seed(6)
    args = kc.egla_args(kind, dtype, g, shape, device=cuda)
    before = kernel.launches
    with torch.no_grad():
        out = kernel(*args)
        ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    kc.assert_outputs_close(out, ref, dtype, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 272, 480, 64), (3, 24, 40, 64),
                                   (5, 8, 8, 64), (2, 16, 24, 64)])
def test_eg2_walk_matches_plain(cuda, shape):
    """The bfloat16 window walk at the main path's shape, at W % 16 == 8
    with CTA shares that cross a frame, at one window a frame (a step's two
    windows in two frames; a CTA of one window, whose partner is dropped)
    and at an odd window count."""
    g = torch.Generator(device=cuda).manual_seed(8)
    args = kc.egla_args("eg2", torch.bfloat16, g, shape, device=cuda)
    with torch.no_grad():
        out = fe.eg2_local_fuse(*args)
        ref = fe.eg2_local_fuse_plain(*args)
    torch.cuda.synchronize()
    kc.assert_outputs_close(out, ref, torch.bfloat16, "eg2")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 5, 20])
def test_eg1_takes_any_height(cuda, h, dtype):
    """H off the TPU kernel's 16-row blocks, and shorter than the 9-row
    band."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(7)
    args = kc.egla_args("eg1", dtype, g, (2, h, 40, 64), device=cuda)
    with torch.no_grad():
        out = fe.eg1_rows(*args)
        ref = fe.eg1_rows_plain(*args)
    torch.cuda.synchronize()
    kc.assert_outputs_close(out, ref, dtype, "eg1")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [300, 704])
def test_eg1_rounds_the_normalised_p(cuda, w):
    """eg1's bfloat16 row attention rounds p = e / sum(e), on the resident
    route (W = 300) and the wide one (704): its v_r is several times nearer
    the normalised-p reference than the unnormalised one."""
    g = torch.Generator(device=cuda).manual_seed(10)
    args = kc.egla_args("eg1", torch.bfloat16, g, (1, 12, w, 64), device=cuda)
    with torch.no_grad():
        vr = fe.eg1_rows(*args)[1].flatten(0, 1).float()
    x, aq, cq, bv, cv, _ = (t.float() for t in args)
    q = (torch.matmul(x, aq[:, None]) + cq[:, None, None]).bfloat16()
    v = (torch.matmul(x, bv) + cv).bfloat16()
    q, v = q.flatten(0, 1), v.flatten(0, 1)
    normalised = fa.token_attention_plain(q, v).float()
    e = torch.exp((lambda s: s - s.amax(-1, keepdim=True))(
        torch.matmul(q.float(), q.float().transpose(1, 2))))
    unnormalised = (torch.matmul(e.bfloat16().float(), v.float())
                    / e.sum(-1, keepdim=True)).bfloat16().float()
    near = (vr - normalised).abs().mean().item()
    far = (vr - unnormalised).abs().mean().item()
    assert far > 4 * near, (near, far)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(EGLA))
def test_egla_kernel_rejects_what_it_does_not_take(cuda, kind):
    kernel, _ = EGLA[kind]
    g = torch.Generator(device=cuda).manual_seed(8)
    x, *rest = kc.egla_args(kind, torch.float32, g, (1, 8, 16, 64),
                            device=cuda)
    before = kernel.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="64 channels"):
            kernel(x[..., :32].contiguous(), *rest)
        with pytest.raises(TypeError):
            kernel(x.bfloat16(), *rest)
        with pytest.raises(ValueError, match="contiguous"):
            kernel(x.transpose(1, 2).contiguous().transpose(1, 2), *rest)
        if kind == "eg1":   # the H-band taps stay float32
            with pytest.raises(TypeError, match="float32"):
                kernel(x, *rest[:-1], rest[-1].bfloat16())
            with pytest.raises(ValueError, match="shapes"):
                kernel(x, rest[0][..., :32].contiguous(), *rest[1:])
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                kernel(x[:, :6].contiguous(), rest[0][:, :6].contiguous(),
                       *rest[1:])
    with pytest.raises(NotImplementedError, match="no backward"):
        kernel(x.clone().requires_grad_(), *rest)
    assert kernel.launches == before


@pytest.mark.cuda
def test_fused_egla_launches_and_matches_unfused(cuda):
    """One eg1, one eg2 and one column launch per fused EGLA call, no token
    launch; the fused module within the float32 tolerance of the unfused
    one, the mask one-hot."""
    from cdfo_tpu_torch.models.attention import EGLA as Module
    from cdfo_tpu_torch.models.layers import init_weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {}
    for fused in (False, True):
        mods[fused] = init_weights(Module(64, fused=fused),
                                   torch.Generator().manual_seed(0))
        with torch.no_grad():
            mods[fused].conv_du_re2[0].bias[3] += 10.0
        mods[fused].to(cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    res, x = (torch.randn(2, 16, 48, 64, generator=g, device=cuda)
              for _ in range(2))
    counts = (fe.eg1_rows, fe.eg2_local_fuse, fa.column_self_attention,
              fa.token_self_attention)
    before = [f.launches for f in counts]
    with torch.no_grad():
        assert mods[True].residual_mask(res).sum(dim=1).tolist() == [1.0,
                                                                     1.0]
        out = mods[True](res, x)
        assert [f.launches - b for f, b in zip(counts, before)] == \
            [1, 1, 1, 0]
        ref = mods[False](res, x)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    assert err <= 2e-4 * ref.abs().max().item()


# -- the int8 Block_ ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 24, 64), (2, 18, 34, 64),
                                   (1, 10, 6, 64), (1, 72, 16, 64),
                                   (1, 8, 8, 64), (3, 26, 42, 64)])
def test_int8_block_matches_plain(cuda, shape, dtype):
    """One to nine serial steps per strip, ragged rows and columns (of the
    walk's strips and steps, and of the 0.5x branch's 16 x 16 tiles: one
    to three tiles a side), an odd strip count over several images; the
    clipped values are counted alike."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(2)
    args = kc.trunk_args("blockq", dtype, g, shape, device=cuda)
    before = fq.scale_block_q.launches
    with torch.no_grad():
        out, clips = fq.scale_block_q(*args, clip_counts=True)
        ref, want = fq.scale_block_q_plain(*args, clip_counts=True)
        again = fq.scale_block_q(*args)
    torch.cuda.synchronize()
    assert fq.scale_block_q.launches == before + 2
    assert torch.equal(out, again)
    kc.assert_outputs_close(out, ref, dtype, "blockq")
    assert (clips - want).abs().max().item() <= 2 + 0.01 * want.max().item()


@pytest.mark.cuda
def test_int8_block_counts_clipped_values(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    x, *ws = kc.trunk_args("blockq", torch.bfloat16, g, (1, 64, 16, 64),
                           device=cuda)
    x[:, 32:] *= 40.0   # rows that outgrow the lagged scale of those above
    with torch.no_grad():
        _, clips = fq.scale_block_q(x, *ws, clip_counts=True)
        _, want = fq.scale_block_q_plain(x, *ws, clip_counts=True)
    assert clips.min().item() > 0
    assert (clips - want).abs().max().item() <= 0.01 * want.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bright", [((1, 8, 8, 64), "pixel"),
                                          ((2, 40, 20, 64), "last"),
                                          ((1, 64, 16, 64), "lower")])
def test_int8_block_runs_a_step_again_past_the_lagged_scale(cuda, shape,
                                                            bright, dtype):
    """A step whose y values pass the lagged scale runs its chunks again at
    their own amax: one pixel 40x brighter in a one-step strip (past the
    step-0 bound, in the walk's last step), the last step's rows 34-39 40x
    brighter (out of the windows of the steps above), the lower half (a
    middle step, then steps within the new running max). The kernel matches
    the plain version, which requantizes, where the clipping one would fail
    the check, and counts the values past the lagged scale alike."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(6)
    x, *ws = kc.trunk_args("blockq", dtype, g, shape, device=cuda)
    rows = {"pixel": slice(3, 4), "last": slice(34, None),
            "lower": slice(shape[1] // 2, None)}[bright]
    cols = slice(4, 5) if bright == "pixel" else slice(None)
    x[:, rows, cols] *= 40.0
    clip = dataclasses.replace(fq.KERNEL_GEOMETRY, requantize=False)
    with torch.no_grad():
        out, clips = fq.scale_block_q(x, *ws, clip_counts=True)
        ref, want = fq.scale_block_q_plain(x, *ws, clip_counts=True)
        clipped = fq.scale_block_q_plain(x, *ws, geometry=clip)
    torch.cuda.synchronize()
    assert want.min().item() > 0
    kc.assert_outputs_close(out, ref, dtype, "blockq")
    err, scale = kc.worst_error(clipped, ref, "blockq")
    assert err > kc.tolerance(dtype, "blockq") * scale
    assert (clips - want).abs().max().item() <= 2 + 0.01 * want.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_block_keeps_the_running_max(cuda, dtype):
    """The first step's rows 40x brighter than the rest, out of every later
    step's windows: the lagged scales of the third and later steps come
    from the bright first step (the running max of the strip), so each
    dim step matches the plain version on its own scale, and the clipped
    values are counted alike."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(5)
    x, *ws = kc.trunk_args("blockq", dtype, g, (2, 40, 20, 64), device=cuda)
    x[:, :6] *= 40.0
    with torch.no_grad():
        out, clips = fq.scale_block_q(x, *ws, clip_counts=True)
        ref, want = fq.scale_block_q_plain(x, *ws, clip_counts=True)
    torch.cuda.synchronize()
    kc.assert_outputs_close(out, ref, dtype, "blockq")
    for r0 in range(16, 40, 8):
        kc.assert_outputs_close(out[:, r0:r0 + 8], ref[:, r0:r0 + 8], dtype,
                                "blockq")
    assert (clips - want).abs().max().item() <= 2 + 0.01 * want.max().item()


@pytest.mark.cuda
def test_int8_block_rejects_what_it_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    args = kc.trunk_args("blockq", torch.float32, g, (1, 8, 8, 64),
                         device=cuda)
    narrow = kc.trunk_args("blockq", torch.float32, g, (1, 8, 8, 32),
                           device=cuda)
    odd = kc.trunk_args("blockq", torch.float32, g, (1, 8, 7, 64),
                        device=cuda)
    before = fq.scale_block_q.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="64 channels"):
            fq.scale_block_q(*narrow)
        with pytest.raises(TypeError):
            fq.scale_block_q(*(a.half() for a in args))
        with pytest.raises(ValueError, match="even"):
            fq.scale_block_q(*odd)
        with pytest.raises(ValueError, match="the kernel walks"):
            fq.scale_block_q(*args, geometry=fq.tpu_geometry(8))
    assert fq.scale_block_q.launches == before


@pytest.mark.cuda
def test_int8_trunk_caches_its_pack(cuda):
    from cdfo_tpu_torch.models.layers import init_weights
    from cdfo_tpu_torch.models.trunk_fast import SCNetFast
    trunk = init_weights(SCNetFast(64, 1, dtype=torch.bfloat16,
                                   use_int8=True),
                         torch.Generator().manual_seed(0)).to(cuda)
    x = torch.randn(1, 16, 16, 64, device=cuda).bfloat16()
    before = fq.scale_block_q.launches
    with torch.no_grad():
        a = trunk(x)
        pack = trunk.body[0].body[0]._pack
        b = trunk(x)
    assert fq.scale_block_q.launches == before + 6
    assert trunk.body[0].body[0]._pack is pack and torch.equal(a, b)
    assert pack[0].dtype == torch.int8 and len(pack) == 15


# -- the block-gather ring warp ---------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 2, 16, 32), (8, 24, 272, 480),
                                   (2, 5, 20, 36), (8, 24, 184, 320),
                                   (8, 24, 400, 640)])
@pytest.mark.parametrize("case", kc.WARP_CASES)
def test_block_warp_matches_plain(cuda, case, shape, dtype):
    """Equal bit for bit: the kernel rounds every product and sum as the
    plain version does, and takes the same path in every block; at the
    main path's shape and at ``tools/bench_fps.py``'s other two
    geometries."""
    from cdfo_tpu_torch.ops.warp import flow_warp_ring
    g = torch.Generator(device=cuda).manual_seed(5)
    ring, idx, flow = kc.warp_args(case, dtype, g, shape, device=cuda)
    before = wb.flow_warp_ring_block.launches
    with torch.no_grad():
        out, paths = wb.flow_warp_ring_block(ring, idx, flow,
                                             return_paths=True)
        ref, want = wb.flow_warp_ring_block_plain(ring, idx, flow,
                                                  return_paths=True)
        shipped = flow_warp_ring(ring, idx, flow)
    torch.cuda.synchronize()
    assert wb.flow_warp_ring_block.launches == before + 1
    assert torch.equal(paths, want) and not paths[:, -1].any()
    assert torch.equal(out, ref)
    kc.assert_outputs_close(out, shipped, dtype, "warp")


@pytest.mark.cuda
def test_warp_neighbours_does_not_wait_for_the_card(cuda):
    """The path is chosen on the device: ``warp_neighbours`` under
    ``block_warp`` synchronises the host nowhere."""
    from cdfo_tpu_torch import ModelConfig
    from cdfo_tpu_torch.models import CVSRV8
    model = CVSRV8(ModelConfig(scn_groups=1, compute_dtype=torch.bfloat16,
                               block_warp=True),
                   generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(6)
    ring, idx, flow = kc.warp_args("mixed", torch.bfloat16, g,
                                   (8, 12, 32, 48), device=cuda)
    ufs = torch.zeros(2, 6, 32, 48, 64, device=cuda)
    args = (ring, ufs, flow.float().reshape(2, 6, 32, 48, 2),
            idx.reshape(2, 6))
    with torch.no_grad():
        model.warp_neighbours(*args)   # builds and loads the library
        torch.cuda.synchronize()
        before = wb.flow_warp_ring_block.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            warped, _, _ = model.warp_neighbours(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert wb.flow_warp_ring_block.launches == before + 1
    torch.cuda.synchronize()
    assert warped.shape == (12, 32, 48, 64) and warped.float().std() > 0


@pytest.mark.cuda
def test_block_warp_rejects_what_it_does_not_take(cuda):
    ring = torch.zeros(3, 8, 12, 64, device=cuda)
    idx = torch.zeros(2, dtype=torch.int64, device=cuda)
    flow = torch.zeros(2, 8, 12, 2, device=cuda)
    before = wb.flow_warp_ring_block.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="64 channels"):
            wb.flow_warp_ring_block(ring[..., :32].contiguous(), idx, flow)
        with pytest.raises(TypeError):
            wb.flow_warp_ring_block(ring, idx, flow.bfloat16())
        with pytest.raises(TypeError, match="integer"):
            wb.flow_warp_ring_block(ring, idx.cpu(), flow)
        with pytest.raises(ValueError, match="multiples of 4"):
            wb.flow_warp_ring_block(ring[:, :6].contiguous(), idx,
                                    flow[:, :6].contiguous())
    assert wb.flow_warp_ring_block.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["token", "column"])
def test_attention_refuses_grad(cuda, kind):
    """The wrappers no longer refuse autograd: under it the kernel launches
    once, the result carries a grad_fn and q's gradient is that of
    autograd through the plain version (float32, TF32 off); under no_grad
    it launches once too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fn, plain = TRAIN_FUNCTIONS[kind][:2]
    shape = (2, 16, 64) if kind == "token" else (1, 16, 8, 64)
    q = torch.randn(shape, device=cuda, requires_grad=True)
    v = torch.randn(shape, device=cuda)
    before = fn.launches
    out = fn(q, v)
    assert fn.launches == before + 1 and out.grad_fn is not None
    (dq,) = torch.autograd.grad(out.square().sum(), q)
    (ref,) = torch.autograd.grad(plain(q, v).square().sum(), q)
    kc.assert_outputs_close(dq, ref, torch.float32)
    with torch.no_grad():
        fn(q, v)
    assert fn.launches == before + 2


# -- the training path: the four kernels' autograd Functions -------------------

# (Function, plain version, the wrapper that counts the launches)
TRAIN_FUNCTIONS = {
    "token": (fa.token_self_attention, fa.token_attention_plain,
              fa.token_self_attention),
    "column": (fa.column_self_attention, fa.column_attention_plain,
               fa.column_self_attention),
    "block": (fv.block_fused, fb.scale_block_plain, fb.scale_block),
    "group": (fv.grouptail_fused, fg.grouptail_plain, fg.grouptail),
    "head": (fv.head_fused, fh.fused_head_plain, fh.fused_head),
}
# the LD preset's (batch 20 of 64x64 crops; EGLA over its 120 neighbour
# images: rows of 7680 tokens, columns of 120 images), then ragged ones
TRAIN_LD = [("token", (7680, 64, 64)), ("column", (120, 64, 64, 64)),
            ("block", (20, 64, 64, 64)), ("group", (20, 64, 64, 64)),
            ("head", (20, 64, 64, 64))]
TRAIN_RAGGED = [("token", (3, 130, 64)), ("column", (2, 70, 9, 64)),
                ("block", (2, 18, 34, 64)), ("group", (2, 18, 34, 64)),
                ("head", (2, 18, 34, 64))]


def _train_args(kind, dtype, g, shape):
    if kind in ("token", "column"):
        return kc.attention_args(dtype, g, shape)
    return kc.trunk_args(kind, dtype, g, shape)


def _grads(fn, args, needs, cot):
    leaves = [a.detach().clone().requires_grad_(n) for a, n in zip(args, needs)]
    out = fn(*leaves)
    return out, torch.autograd.grad(
        out, [t for t, n in zip(leaves, needs) if n], cot.to(out.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape", TRAIN_LD + TRAIN_RAGGED)
def test_function_gradients_match_autograd_through_plain(cuda, kind, shape,
                                                         dtype):
    """Each Function with its kernel forward (one launch, none in the
    backward) against autograd through the plain version: the forward
    within the kernel's tolerance, every gradient within the dtype's
    tolerance of its largest value, in bfloat16 plus the plain bfloat16
    gradient's own distance from the float32 one (``tests/test_torch_vjp``'s
    rule: both sides round along the backward)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn, plain, counter = TRAIN_FUNCTIONS[kind]
    g = torch.Generator(device=cuda).manual_seed(11)
    args = _train_args(kind, dtype, g, shape)
    needs = [not (kind == "head" and i == 1) for i in range(len(args))]
    shape_out = plain(*args).shape
    cot = torch.randn(shape_out, generator=g, device=cuda)
    before = counter.launches
    out, got = _grads(fn, args, needs, cot)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref_out, ref = _grads(plain, args, needs, cot)
    kc.assert_outputs_close(out.detach(), ref_out.detach(), dtype, kind)
    exact = (_grads(plain, [a.float() for a in args], needs, cot)[1]
             if dtype == torch.bfloat16 else [None] * len(ref))
    for i, (a, b, b32) in enumerate(zip(got, ref, exact)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        slack = 0.0 if b32 is None else (b.float() - b32).abs().max().item()
        assert err <= kc.tolerance(dtype) * scale + slack, (i, err, scale,
                                                            slack)


# -- the trunk microbenchmarks' kernels (Block_ body pair, probes) ------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(1, 16, 32, 64), (2, 18, 34, 64),
                                   (1, 5, 7, 64), (4, 272, 480, 64),
                                   (4, 184, 320, 64), (4, 400, 640, 64),
                                   (1, 3, 124, 64)])
def test_body_kernel_matches_plain(cuda, shape, residual, dtype):
    """Whole tiles, ragged right and bottom edges, and an odd extent
    smaller than one tile; the main shape and ``tools/bench_fps.py``'s
    other two geometries (bfloat16: 62-column strips, the last 46, 10
    and 20 wide), and two whole strips of 3 rows."""
    from cdfo_tpu_torch.ops import fused_block as fbody
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(10)
    args = kc.body_args(dtype, g, shape, device=cuda)
    before = fbody.block_body.launches
    with torch.no_grad():
        out = fbody.block_body(*args, residual=residual)
        ref = fbody.block_body_plain(*args, residual=residual)
    torch.cuda.synchronize()
    assert fbody.block_body.launches == before + 1
    kc.assert_outputs_close(out, ref, dtype, "body")


@pytest.mark.cuda
def test_body_kernel_takes_a_kept_pack(cuda):
    """The bfloat16 body pair with its resident slices packed once gives
    the call's own result bit for bit."""
    from cdfo_tpu_torch.ops import fused_block as fbody
    g = torch.Generator(device=cuda).manual_seed(10)
    x, w1, b1, w2, b2 = kc.body_args(torch.bfloat16, g, (2, 40, 130, 64),
                                     device=cuda)
    packed = fbody.pack_body_weights(w1, w2, torch.bfloat16)
    with torch.no_grad():
        a = fbody.block_body(x, w1, b1, w2, b2)
        b = fbody.block_body(x, w1, b1, w2, b2, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,reps", [
    *((m, k, n, 7) for m, k, n in mbd.DOT_CASES),
    (64, 768, 132, 7), (128, 128, 260, 5), (256, 576, 70, 3)])
def test_dot_probe_matches_plain(cuda, m, k, n, reps):
    """Every case of the tool's list (m = 64, 128 and 256; K split over
    CTAs at (64, 768), (64, 1024) and (256, 576)) and ragged n; resident
    planes also streamed on request."""
    from cdfo_tpu_torch.ops import probe_dots as pd
    g = torch.Generator(device=cuda).manual_seed(11)
    lhs, rhs = kc.dots_args(g, m, k, n, device=cuda)
    ref = pd.dot_case_plain(lhs, rhs, reps)
    for streamed in (False, True):
        before = pd.dot_case.launches
        out = pd.dot_case(lhs, rhs, reps, streamed=streamed)
        torch.cuda.synchronize()
        assert pd.dot_case.launches == before + 1
        kc.assert_outputs_close(out, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,c,n", [
    *(("rowpipe", *case) for case in mbd.ROWPIPE_CASES),
    *(("kstack", *case) for case in mbd.KSTACK_CASES),
    ("rowpipe", 128, 64, 132), ("kstack", 128, 64, 132),
    ("kstack", 64, 256, 132), ("rowpipe", 64, 128, 132),
    ("rowpipe", 128, 192, 132), ("kstack", 64, 512, 68)])
def test_row_probes_match_plain(cuda, kind, m, c, n):
    """Every case of the tool's lists and ragged ones: rowpipe at each tile
    it takes (its weights whole in a CTA, split by output channels, or by
    input channels over a cluster of c / 64: 2, 3 and 4), kstack at its
    own (and by input channels over clusters of 4 and 8); kstack refuses
    reps <= nrows."""
    from cdfo_tpu_torch.ops import probe_dots as pd
    g = torch.Generator(device=cuda).manual_seed(12)
    args = kc.rows_args(g, m, c, n, 8, device=cuda)
    with pytest.raises(ValueError, match="reps"):
        pd.kstack(*args, 8, 8)
    runs = ([pd.kstack] if kind == "kstack" else
            [functools.partial(pd.rowpipe, mt=mt) for mt in pd.KERNEL_MT])
    plain = pd.kstack_plain if kind == "kstack" else pd.rowpipe_plain
    for run in runs:
        for reps in (9, 30):
            out = run(*args, reps, 8)
            torch.cuda.synchronize()
            kc.assert_outputs_close(out, plain(*args, reps, 8),
                                    torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rowpipe", "kstack"])
def test_row_probes_refuse_more_than_a_cluster(cuda, kind):
    """At c = 576 the weights' nine 64-channel chunks would need a cluster
    of 9 CTAs, past the 8 a portable cluster holds: both raise."""
    from cdfo_tpu_torch.ops import probe_dots as pd
    g = torch.Generator(device=cuda).manual_seed(12)
    args = kc.rows_args(g, 64, 576, 68, 8, device=cuda)
    with pytest.raises(ValueError, match="c at most 512"):
        getattr(pd, kind)(*args, 9, 8)


@pytest.mark.cuda
def test_dma_probe_gathers_tall_patches(cuda):
    """Patches of 300 rows (two boxes of 150 rows each) of 17 8-lane pixels,
    starts off the 64-lane boundaries and past the ring's end."""
    from cdfo_tpu_torch.ops import probe_dma as pm
    g = torch.Generator(device=cuda).manual_seed(13)
    ring = torch.randn(320, 512, generator=g, device=cuda).bfloat16()
    starts = torch.randint(0, 400, (2 * 40,), generator=g, device=cuda,
                           dtype=torch.int32)
    out = pm.gather(ring, starts, 300, 136)
    torch.cuda.synchronize()
    kc.assert_outputs_close(out, pm.gather_plain(ring, starts, 300, 136),
                            torch.bfloat16, "gather")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 24])
@pytest.mark.parametrize("mode", ["patch", "row", "run16", "big"])
def test_dma_probe_matches_plain(cuda, mode, shift):
    """The tool's modes; ``shift`` moves every other patch's lane start off
    the 64-lane boundaries (the gather's narrow map: run16's patch of 528
    8-lane pixels as three boxes)."""
    import numpy as np
    from cdfo_tpu_torch.ops import probe_dma as pm
    rng = np.random.RandomState(3)
    pw = pm.PATCHES.get(mode, (8, 6))[1]
    ring, starts = kc.dma_args(rng, 64, 96, 64, 300, pw, device=cuda)
    starts[1::4] += shift
    if mode == "big":
        rows = pm.big_rows(64, 96, 300)
        out, ref = pm.big(ring, starts, rows), pm.big_plain(ring, starts, rows)
        kind = "big"
    else:
        ph = pm.PATCHES[mode][0]
        out = pm.gather(ring, starts, ph, pw * 64)
        ref = pm.gather_plain(ring, starts, ph, pw * 64)
        kind = "gather"
    torch.cuda.synchronize()
    kc.assert_outputs_close(out, ref, torch.bfloat16, kind)


# every model-path kernel at the JCT-VC geometries that the eval tools feed
# it (400x640 and 184x320, `tools/eval_jctvc.py:20-31`), at the engine's
# k = 4 shapes (4 frames, 6 neighbours of 4 centres, EGLA over 4 frames) and
# at the per-window forward's (1 frame, 6 neighbours of 1 centre, EGLA over
# 6 frames)
MODEL_PATH = {
    "block": (fb.scale_block, fb.scale_block_plain),
    "blockq": (fq.scale_block_q, fq.scale_block_q_plain),
    "group": (fg.grouptail, fg.grouptail_plain),
    "head": (fh.fused_head, fh.fused_head_plain),
    "tail": (ft.resblock_pair, ft.resblock_pair_plain),
    **ALIGN_EMBED, **EGLA,
    "token": (fa.token_self_attention, fa.token_attention_plain),
    "column": (fa.column_self_attention, fa.column_attention_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("m,e", [(4, 4), (1, 6)], ids=["k4", "window"])
@pytest.mark.parametrize("h,w", [(400, 640), (184, 320)])
@pytest.mark.parametrize("kind", list(MODEL_PATH))
def test_model_path_kernel_at_eval_geometries(cuda, kind, h, w, m, e):
    kernel, plain = MODEL_PATH[kind]
    g = torch.Generator(device=cuda).manual_seed(9)
    dt = torch.bfloat16
    if kind in ("token", "column"):
        shape = (e * h, w, 64) if kind == "token" else (e, h, w, 64)
        args = kc.attention_args(dt, g, shape, device=cuda)
    elif kind in EGLA:
        args = kc.egla_args(kind, dt, g, (e, h, w, 64), device=cuda)
    elif kind in ALIGN_EMBED:
        args = kc.align_embed_args(kind, dt, g, (m, h, w), 6, device=cuda)
    else:
        args = kc.trunk_args(kind, dt, g, (m, h, w, 64), nbr=6, device=cuda)
    before = kernel.launches
    with torch.no_grad():
        out = kernel(*args)
        ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    kc.assert_outputs_close(out, ref, dt, kind)


# -- the model zoo: card against CPU ----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(kc.ABLATIONS))
def test_ablation_engine_card_matches_cpu(cuda, name):
    """Each CVSR_V8 ablation with every kernel flag it admits, through the
    engine at phase 4's size (nf 64, 2 groups, 9 frames of 16x24, k = 4,
    float32, TF32 off): the card's uint8 frames within 1 LSB of the CPU's
    (plain versions) on the same weights."""
    from cdfo_tpu_torch import ModelConfig
    from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ablation = kc.ABLATIONS[name]
    cfg = ModelConfig(scn_groups=2, **ablation, **kc.admitted_flags(ablation))
    data = synthetic_sequence(t=9, h=16, w=24, seed=3)
    out = {dev: BatchedStreamingEngine(kc.zoo_model(cfg, dev), k=4)
           .run_sequence(data)[0] for dev in ("cpu", cuda)}
    diff = abs(out[cuda].astype("int32") - out["cpu"].astype("int32"))
    assert diff.max() <= 1 and out[cuda].std() > 0, diff.max()


@pytest.mark.cuda
def test_v7_dcn_card_matches_cpu(cuda):
    """CVSR_V7's deformable alignment (16 deformable groups, the offset
    heads refilled so the offsets are more than the flow) on the card
    against the CPU, float32: within 1e-4 of the CPU's largest value."""
    from cdfo_tpu_torch import ModelConfig
    torch.backends.cudnn.allow_tf32 = False
    model = kc.zoo_model(ModelConfig(name="cvsr_v7", scn_groups=1), "cpu")
    align = model.MV_deform_align
    g = torch.Generator().manual_seed(2)
    x, extra, pred = (torch.randn(12, 32, 48, 64, generator=g)
                      for _ in range(3))
    flow = torch.randn(12, 32, 48, 2, generator=g) * 3
    with torch.no_grad():
        ref = align(x, extra, pred, flow)
        out = align.to(cuda)(*(t.to(cuda) for t in (x, extra, pred, flow)))
    err = (out.cpu() - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err


# -- the multi-card paths ----------------------------------------------------------

@pytest.mark.cuda
def test_sharded_engine_over_one_card_equals_the_plain_engine(cuda):
    """``ShardedServingEngine`` over a process group of one card (NCCL,
    k_per_device = 4) against the plain engine (k = 4) on one model: every
    kernel flag, bf16, phase 4's size, uint8 frames bit for bit, timed and
    untimed."""
    import torch.distributed as dist
    from cdfo_tpu_torch import ModelConfig
    from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
    from cdfo_tpu_torch.parallel import initialize_distributed
    from cdfo_tpu_torch.parallel.serving import ShardedServingEngine
    cfg = ModelConfig(scn_groups=2, compute_dtype=torch.bfloat16,
                      fused_trunk=True, fused_embed=True, fused_align=True,
                      fused_egla=True, trunk_int8=True, block_warp=True)
    model = kc.zoo_model(cfg, cuda)
    data = synthetic_sequence(t=9, h=16, w=24, seed=3)
    plain = BatchedStreamingEngine(model, k=4).run_sequence(data)[0]
    assert initialize_distributed("cuda") == (0, 1)
    try:
        assert dist.get_backend() == "nccl"
        eng = ShardedServingEngine(model, k_per_device=4)
        frames = eng.run_sequence(data)[0]
        timed, fps = eng.run_sequence(data, collect_timing=True)
    finally:
        dist.destroy_process_group()
    assert (frames == plain).all() and (timed == plain).all()
    assert plain.std() > 0 and fps > 0
