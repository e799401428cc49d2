"""The ``'spatial'`` mesh axis: frame rows split over ranks (counterpart of
the 2-D ``make_mesh`` and ``spatial_spec`` of ``cdfo_tpu/parallel/mesh.py``,
where H is sharded over ``'spatial'`` and XLA inserts the halo exchanges
and collectives).

Here nothing inserts them, so the plain modules of CVSR_V8 ask for them
while a split is active (``sharded(shard)``; ``split()`` is ``None`` on
every other path, and then each module runs its unsharded code):

- ``halo``: rows of the neighbouring ranks around this rank's rows (zeros
  or the edge row replicated beyond the global edges), for the convs and
  the 2x / 4x resizes;
- ``all_reduce_sum`` / ``spatial_mean``: sums over the global H.W (the
  CALayer and gate means, the channel attention's norms and grams, EGLA's
  mask logits);
- ``gather_rows``: the whole H on every rank (EGLA's column attention, the
  flow warp's source, the side encoder's U-Net), uneven shards padded to
  the largest for the collective and stripped again.

Each is an autograd Function whose backward sends the gradients back to
the rows' owners, so a train step's backward runs through them. A
``SpatialShard`` holds the global H, every rank's rows and this rank's
place; H is split in whole 8-row windows (EGLA's 8x8 windows and the 0.5x
resize never straddle two ranks). Row counts at other resolutions (0.5x,
2x, 4x) follow from a tensor's own height: every rank's rows scale alike.

``make_mesh((d, s), ("data", "spatial"))`` lays the ranks out as JAX's mesh
does (rank = data index * s + spatial index) and gives each rank its
``'data'`` and ``'spatial'`` process groups. ``collective_bytes`` counts,
per tag, the calls and the bytes each collective delivers to this rank
from the others (an all-reduce: its tensor's bytes).
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
from fractions import Fraction

import torch
import torch.distributed as dist

WINDOW = 8
# the item of ROADMAP.md that the paths refused under a split wait for
ROADMAP_ITEM = "ROADMAP Queue 1 item 10"

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("cdfo_spatial",
                                                         default=None)
collective_bytes: collections.Counter = collections.Counter()
collective_calls: collections.Counter = collections.Counter()


def split_rows(height: int, parts: int) -> tuple[int, ...]:
    """``height`` rows split over ``parts`` ranks in whole 8-row windows,
    as evenly as possible, the larger shares first (272 over 4: 72, 72, 64,
    64)."""
    if height % WINDOW:
        raise ValueError(f"H={height} is not a multiple of {WINDOW}: the "
                         "EGLA windows need it, split or not")
    windows = height // WINDOW
    if parts < 1 or windows < parts:
        raise ValueError(f"H={height} holds {windows} windows of {WINDOW} "
                         f"rows: not one for each of {parts} ranks")
    base, extra = divmod(windows, parts)
    return tuple((base + (i < extra)) * WINDOW for i in range(parts))


@dataclasses.dataclass(frozen=True)
class SpatialShard:
    """This rank's rows of a frame of ``height`` rows: ``rows`` holds every
    rank's, in the order of the ``'spatial'`` group, ``index`` this rank's
    place, ``group`` the group (``None`` for a group of one).
    ``data_index`` / ``data_size``: the rank's place on the ``'data'``
    axis."""
    height: int
    rows: tuple
    index: int = 0
    group: object = None
    data_index: int = 0
    data_size: int = 1

    def __post_init__(self):
        if sum(self.rows) != self.height or not 0 <= self.index < self.size:
            raise ValueError(f"rows {self.rows} do not split H={self.height}"
                             f" at index {self.index}")

    @property
    def size(self) -> int:
        return len(self.rows)

    def rows_at(self, n: int) -> tuple:
        """Every rank's rows at the resolution where this rank holds
        ``n``."""
        scale = Fraction(n, self.rows[self.index])
        rows = tuple(r * scale for r in self.rows)
        if any(r.denominator != 1 for r in rows):
            raise ValueError(f"{n} rows of a shard of {self.rows[self.index]}"
                             f" do not scale every rank's {self.rows}")
        return tuple(int(r) for r in rows)

    def bounds_at(self, n: int) -> tuple[int, int]:
        """(start, stop) of this rank's rows where it holds ``n``."""
        rows = self.rows_at(n)
        start = sum(rows[:self.index])
        return start, start + n

    def take(self, x, axis: int = 1):
        """This rank's rows of ``x`` (a tensor or an array) along ``axis``,
        whose length is a whole multiple or fraction of ``height``."""
        n = x.shape[axis] * self.rows[self.index]
        if n % self.height:
            raise ValueError(f"{x.shape[axis]} rows do not scale H="
                             f"{self.height}")
        start, stop = self.bounds_at(n // self.height)
        return x[(slice(None),) * axis + (slice(start, stop),)]


def split() -> SpatialShard | None:
    """The active shard, where it has two or more ranks: what the plain
    modules consult. A group of one runs the unsharded code."""
    shard = _ACTIVE.get()
    return shard if shard is not None and shard.size > 1 else None


def current_shard() -> SpatialShard | None:
    """The active shard of any size (the models refuse the paths that have
    no split under it)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sharded(shard: SpatialShard | None):
    """Runs the block with ``shard`` active (``None``: no split, as inside
    a part that every rank computes whole)."""
    token = _ACTIVE.set(shard)
    try:
        yield shard
    finally:
        _ACTIVE.reset(token)


def refuse_split(what: str) -> None:
    """Raises ``ValueError`` where a shard is active: ``what`` has no split
    over the ``'spatial'`` axis."""
    if _ACTIVE.get() is not None:
        raise ValueError(f"{what} does not run split over the 'spatial' "
                         f"axis ({ROADMAP_ITEM}); the split runs the plain "
                         f"CVSR_V8 family")


# -- collectives ----------------------------------------------------------------

def _gather(x: torch.Tensor, shard: SpatialShard, tag: str) -> torch.Tensor:
    """Every rank's ``x`` (one shape) stacked on a new leading axis."""
    out = x.new_empty((shard.size * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_single takes over from all_gather_into_tensor (deprecated
    # in newer torch), which older ones have alone
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=shard.group)
    out = out.view((shard.size,) + tuple(x.shape))
    collective_calls[tag] += 1
    collective_bytes[tag] += (shard.size - 1) * x.numel() * x.element_size()
    return out


def _reduce(x: torch.Tensor, shard: SpatialShard, tag: str) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=shard.group)
    collective_calls[tag] += 1
    collective_bytes[tag] += y.numel() * y.element_size()
    return y


def _edge(x: torch.Tensor, n: int, edge: str, first: bool) -> torch.Tensor:
    if edge == "zeros":
        return x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    row = x[:, :1] if first else x[:, -1:]
    return row.expand((x.shape[0], n) + tuple(x.shape[2:]))


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, edge, shard, tag):
        ctx.top, ctx.bottom, ctx.edge, ctx.shard, ctx.tag = (top, bottom,
                                                             edge, shard, tag)
        n, i, last = x.shape[1], shard.index, shard.size - 1
        if max(top, bottom) > min(shard.rows_at(n)):
            raise ValueError(f"a halo of {max(top, bottom)} rows exceeds "
                             f"the least rank's {min(shard.rows_at(n))}")
        # each rank hands over its last `top` rows (the next rank's top
        # halo) and its first `bottom` rows (the previous rank's bottom)
        got = _gather(torch.cat([x[:, n - top:], x[:, :bottom]], dim=1),
                      shard, tag)
        up = got[i - 1][:, :top] if i > 0 else _edge(x, top, edge, True)
        down = (got[i + 1][:, top:] if i < last
                else _edge(x, bottom, edge, False))
        return torch.cat([up, x, down], dim=1)

    @staticmethod
    def backward(ctx, g):
        top, bottom, shard = ctx.top, ctx.bottom, ctx.shard
        n = g.shape[1] - top - bottom
        i, last = shard.index, shard.size - 1
        g_up, g_down = g[:, :top], g[:, top + n:]
        gx = g[:, top:top + n].clone()
        # the halos' gradients go back to the rows' owners
        got = _gather(torch.cat([g_up, g_down], dim=1), shard, ctx.tag)
        if i < last and top:
            gx[:, n - top:] += got[i + 1][:, :top]
        if i > 0 and bottom:
            gx[:, :bottom] += got[i - 1][:, top:]
        if ctx.edge == "replicate":
            if i == 0 and top:
                gx[:, :1] += g_up.sum(dim=1, keepdim=True)
            if i == last and bottom:
                gx[:, -1:] += g_down.sum(dim=1, keepdim=True)
        return gx, None, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, edge: str,
         shard: SpatialShard, tag: str = "halo") -> torch.Tensor:
    """``x`` (B, n, ...) with ``top`` rows of the previous rank above it
    and ``bottom`` rows of the next below; beyond the global edges zeros
    (``edge="zeros"``, a conv's padding) or the edge row repeated
    (``"replicate"``, a resize's clamp). One all-gather of the edge rows
    (every rank's, so that no rank waits on a pair), and one in the
    backward."""
    if edge not in ("zeros", "replicate"):
        raise ValueError(f"edge {edge!r}: 'zeros' or 'replicate'")
    if top == bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, edge, shard, tag)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, tag):
        ctx.shard, ctx.tag = shard, tag
        return _reduce(x, shard, tag)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.shard, ctx.tag), None, None


def all_reduce_sum(x: torch.Tensor, shard: SpatialShard,
                   tag: str = "all_reduce") -> torch.Tensor:
    """The sum of every rank's ``x`` over the spatial group."""
    return _AllReduceSum.apply(x, shard, tag)


def spatial_mean(x: torch.Tensor, tag: str = "mean") -> torch.Tensor:
    """``x.mean(dim=(1, 2), keepdim=True)`` over the global H.W of the
    active split: the local sums and pixel count in float32, all-reduced
    together, then divided. Without a split, the mean itself."""
    shard = split()
    if shard is None:
        return x.mean(dim=(1, 2), keepdim=True)
    b, c = x.shape[0], x.shape[-1]
    sums = x.float().sum(dim=(1, 2)).reshape(-1)
    count = sums.new_full((1,), float(x.shape[1] * x.shape[2]))
    total = all_reduce_sum(torch.cat([sums, count]), shard, tag)
    return (total[:-1] / total[-1]).reshape(b, 1, 1, c).to(x.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, tag):
        ctx.shard, ctx.tag = shard, tag
        rows = shard.rows_at(x.shape[1])
        ctx.bounds = shard.bounds_at(x.shape[1])
        most = max(rows)
        pad = x.new_zeros((x.shape[0], most - x.shape[1]) + tuple(x.shape[2:]))
        got = _gather(torch.cat([x, pad], dim=1), shard, tag)
        return torch.cat([got[j][:, :r] for j, r in enumerate(rows)], dim=1)

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.bounds
        return (_reduce(g, ctx.shard, ctx.tag)[:, start:stop].contiguous(),
                None, None)


def gather_rows(x: torch.Tensor, shard: SpatialShard,
                tag: str = "gather") -> torch.Tensor:
    """The whole H of ``x`` (B, n, ...) on every rank, ranks in order. Its
    backward sums every rank's gradient of the whole and keeps this rank's
    rows."""
    return _GatherRows.apply(x, shard, tag)


def conv_halo(x: torch.Tensor, k: int, stride: int, pad: int,
              shard: SpatialShard) -> torch.Tensor:
    """``x``'s rows widened for a conv along H (kernel ``k``, ``stride``,
    zero padding ``pad``) run with no H padding: this rank computes the
    outputs i with ``stride * i`` in its rows (the last rank also those past
    them), whose taps reach ``pad`` rows above and ``k - 1 - pad`` below
    at stride 1. One halo for every rank's need, then cropped to this
    rank's."""
    rows = shard.rows_at(x.shape[1])
    h = sum(rows)
    h_out = (h + 2 * pad - k) // stride + 1
    need, start = [], 0
    for j, n in enumerate(rows):
        first = -(-start // stride)
        last = (h_out - 1 if j == len(rows) - 1
                else (start + n - 1) // stride)
        need.append((start - (stride * first - pad),
                     stride * last - pad + k - 1 - (start + n - 1)))
        start += n
    top = max(0, *(t for t, _ in need))
    bottom = max(0, *(b for _, b in need))
    ext = halo(x, top, bottom, "zeros", shard, "conv_halo")
    mine_top, mine_bottom = need[shard.index]
    return ext[:, top - mine_top:top + x.shape[1] + mine_bottom]


# -- the mesh -------------------------------------------------------------------

class Mesh:
    """The ``(data, spatial)`` mesh over the default process group (or a
    process of its own when there is none and the mesh is (1, 1)): this
    rank's coordinates and its two process groups (``None`` for a group of
    one)."""

    def __init__(self, shape, axis_names=("data", "spatial")):
        if tuple(axis_names) != ("data", "spatial") or len(shape) != 2:
            raise ValueError(f"a mesh of axes ('data', 'spatial'), got "
                             f"{tuple(axis_names)} of shape {tuple(shape)}")
        d, s = (int(v) for v in shape)
        ready = dist.is_available() and dist.is_initialized()
        rank, world = ((dist.get_rank(), dist.get_world_size()) if ready
                       else (0, 1))
        if d * s != world:
            raise ValueError(f"a ({d}, {s}) mesh over {world} ranks")
        self.shape = (d, s)
        self.axis_names = ("data", "spatial")
        self.data_index, self.spatial_index = divmod(rank, s)
        self.data_group = self.spatial_group = None
        # every rank makes every group, in one order
        if s > 1:
            for i in range(d):
                group = dist.new_group(list(range(i * s, (i + 1) * s)))
                if i == self.data_index:
                    self.spatial_group = group
        if d > 1:
            for j in range(s):
                group = dist.new_group([i * s + j for i in range(d)])
                if j == self.spatial_index:
                    self.data_group = group

    def shard(self, height: int) -> SpatialShard:
        """This rank's share of a frame of ``height`` rows."""
        return SpatialShard(height, split_rows(height, self.shape[1]),
                            self.spatial_index, self.spatial_group,
                            self.data_index, self.shape[0])

    def split_batch(self, batch: dict) -> dict:
        """This rank's part of a global batch of NHWC arrays or tensors:
        leading-axis rows by the ``'data'`` index, H by the ``'spatial'``
        one (axis 2 of the 5-D inputs, axis 1 of the 4-D ones; ``hr``'s at
        four times the rows), as ``cdfo_tpu``'s dry run puts them."""
        height = batch["lrs"].shape[2]
        shard = self.shard(height)
        d = self.shape[0]
        out = {}
        for k, v in batch.items():
            if len(v) % d:
                raise ValueError(f"{k}: {len(v)} rows over {d} data ranks")
            per = len(v) // d
            v = v[self.data_index * per:(self.data_index + 1) * per]
            out[k] = shard.take(v, 2 if v.ndim == 5 else 1)
        return out


def make_mesh(shape, axis_names=("data", "spatial")) -> Mesh:
    """The counterpart of ``cdfo_tpu``'s 2-D ``make_mesh``."""
    return Mesh(shape, axis_names)
