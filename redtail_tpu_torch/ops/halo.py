"""Sharded axes: who owns which rows, the exchange that fetches the rows a
rank needs from the others, and the context that tells the ops a block runs
sharded (in the JAX package GSPMD partitions the ops and inserts these halo
exchanges; here the port's convs and soft-argmin ask for them).

**Ownership.** Rank ``r`` of ``S`` owns rows ``[r * G // S, (r + 1) * G //
S)`` of an axis of global size ``G`` (`owned`). A shard may be empty: the
disparity axis halves at each strided layer, down to fewer rows than ranks.

**Exchange.** `exchange(x, axis=, global_size=, need=, group=)` returns the
global rows ``[lo, hi)`` this rank needs (``need[rank]``), zeros outside
``[0, G)``. Every rank knows every rank's need (they follow from the layer's
shape), so the slabs are planned without a message: each rank contributes
the first and the last ``t`` rows of its shard, ``t`` the longest run any
other rank needs from one shard, or its whole shard padded to the longest
where that is no larger; one ``all_gather`` over the group moves the slabs.
The backward sends each fetched row's gradient back to its owner: the
gradients are placed in the gathered slabs' layout, summed over the group
by one ``all_reduce`` in fp32, and each rank adds its own slab's sums to
its rows. Only ``all_gather`` and ``all_reduce`` are used, which gloo also
runs on CUDA tensors.

Every rank of the group must call `exchange` with the same ``need`` list,
in the same order, forward and backward. ``exchange.moved`` counts the
bytes each forward call receives from the other ranks and
``exchange.held`` the bytes of the shards it was called on (this rank's
activations), for the traffic's share.

**Context.** `sharded_axis(group, axis, global_size)` marks a block whose
NCHW / NCDHW activations each rank of ``group`` holds its rows of, along
``axis`` (`IMAGE_AXIS`, H, or `DISPARITY_AXIS`, D); `current_sharding()`
reads it (`ops/convolution.py`, `ops/softargmax.py`, `models/stereo.py`)
and `sharded_extent` moves the global size from layer to layer.

**Rows a rank reads.** An op on a sharded axis owns the rows of its
output under the ownership rule and fetches the input rows they read:
`fetch` runs that one exchange for a ``need(a, b)`` rule, `window_rows`
is the rule of a window op (a conv, a transposed conv as a conv of the
dilated input), and `halo_rows` is `fetch` with that rule plus the pads
that make the op over the slab give exactly its own rows. The convs,
the packed ops, the emission and the D-folded deconv all plan through
these. A rank that owns no rows still calls the exchange, then returns
`empty_shard` tied to its slab. The module imports no model and no
parallel code: `parallel/` re-exports it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

Range = Tuple[int, int]


def owned(global_size: int, shards: int, index: int) -> Range:
    """The rows ``[lo, hi)`` of an axis of ``global_size`` that shard
    ``index`` of ``shards`` owns."""
    return (index * global_size // shards,
            (index + 1) * global_size // shards)


def shard(x: torch.Tensor, axis: int, shards: int, index: int
          ) -> torch.Tensor:
    """This shard's rows of the global ``x`` along ``axis`` (a view)."""
    lo, hi = owned(x.shape[axis], shards, index)
    return x.narrow(axis, lo, hi - lo)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one exchange moves rows: every rank sends ``rows`` rows, its
    whole shard zero-padded (``whole``) or its first ``t`` rows then its
    last ``t`` rows, each zero-padded to ``t``."""

    global_size: int
    shards: int
    t: int
    whole: bool

    @property
    def rows(self) -> int:
        return self.t if self.whole else 2 * self.t

    def slab_row(self, g: int) -> int:
        """The slab position of global row ``g`` in its owner's slab."""
        owner = owner_of(self.global_size, self.shards, g)
        lo, hi = owned(self.global_size, self.shards, owner)
        if self.whole or g - lo < self.t:
            pos = g - lo
        else:
            pos = 2 * self.t - (hi - g)
        return owner * self.rows + pos


def owner_of(global_size: int, shards: int, g: int) -> int:
    """The shard that owns global row ``g`` (in [0, global_size))."""
    r = min(shards - 1, g * shards // global_size)
    while owned(global_size, shards, r)[0] > g:
        r -= 1
    while owned(global_size, shards, r)[1] <= g:
        r += 1
    return r


@functools.lru_cache(maxsize=None)
def plan(global_size: int, shards: int, need: Tuple[Range, ...]) -> Plan:
    """The slab layout for ``need`` (each rank's wanted rows)."""
    longest = max(owned(global_size, shards, r)[1]
                  - owned(global_size, shards, r)[0] for r in range(shards))
    t, middle = 0, False
    for q, (lo, hi) in enumerate(need):
        for r in range(shards):
            if r == q:
                continue
            a, b = owned(global_size, shards, r)
            c, d = max(lo, a), min(hi, b)
            if c >= d:
                continue
            t = max(t, d - c)
            middle |= c > a and d < b  # touches neither end of r's shard
    if middle or 2 * t >= longest:
        return Plan(global_size, shards, longest, True)
    return Plan(global_size, shards, t, False)


def _pad_rows(x: torch.Tensor, axis: int, before: int, after: int
              ) -> torch.Tensor:
    if before == 0 and after == 0:
        return x
    pads = [0, 0] * (x.dim() - 1 - axis) + [before, after]
    return F.pad(x, pads)


def _slab(x: torch.Tensor, axis: int, p: Plan) -> torch.Tensor:
    n = x.shape[axis]
    if p.whole:
        return _pad_rows(x, axis, 0, p.t - n)
    k = min(p.t, n)
    head = _pad_rows(x.narrow(axis, 0, k), axis, 0, p.t - k)
    tail = _pad_rows(x.narrow(axis, n - k, k), axis, p.t - k, 0)
    return torch.cat([head, tail], dim=axis)


def _fetch_index(p: Plan, lo: int, hi: int, device) -> torch.Tensor:
    """For rows ``[lo, hi)`` (none of them this rank's), their positions in
    the gathered slabs; a row outside [0, G) points at the zero row after
    them."""
    zero = p.shards * p.rows
    idx = [p.slab_row(g) if 0 <= g < p.global_size else zero
           for g in range(lo, hi)]
    return torch.tensor(idx, dtype=torch.long, device=device)


def _pieces(lo: int, hi: int, a: int, b: int) -> List[Tuple[str, int, int]]:
    """[lo, hi) split around this rank's rows [a, b): ('fetch', lo, hi)
    and ('own', lo, hi) pieces in order."""
    out = []
    if lo < min(a, hi):
        out.append(("fetch", lo, min(a, hi)))
    if max(lo, a) < min(hi, b):
        out.append(("own", max(lo, a), min(hi, b)))
    if max(lo, b) < hi:
        out.append(("fetch", max(lo, b), hi))
    return out


class _Exchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, need, group, index, shards, global_size):
        p = plan(global_size, shards, need)
        a, b = owned(global_size, shards, index)
        if x.shape[axis] != b - a:
            raise ValueError(f"rank {index} of {shards} holds "
                             f"{x.shape[axis]} rows of axis {axis}, owns "
                             f"{b - a} of {global_size}")
        slab = _slab(x, axis, p).contiguous()
        parts = [torch.empty_like(slab) for _ in range(shards)]
        dist.all_gather(parts, slab, group=group)
        exchange.moved += (shards - 1) * slab.numel() * slab.element_size()
        exchange.held += x.numel() * x.element_size()
        zero = list(slab.shape)
        zero[axis] = 1
        gathered = torch.cat(parts + [slab.new_zeros(zero)], dim=axis)
        lo, hi = need[index]
        pieces = _pieces(lo, hi, a, b)
        out = []
        for kind, p_lo, p_hi in pieces:
            if kind == "own":
                out.append(x.narrow(axis, p_lo - a, p_hi - p_lo))
            else:
                out.append(gathered.index_select(
                    axis, _fetch_index(p, p_lo, p_hi, x.device)))
        ctx.conf = (axis, p, pieces, a, index, tuple(slab.shape), group,
                    x.shape)
        if not out:
            shape = list(x.shape)
            shape[axis] = 0
            return x.new_zeros(shape)
        return torch.cat(out, dim=axis) if len(out) > 1 else out[0].clone()

    @staticmethod
    def backward(ctx, g):
        axis, p, pieces, a, index, slab_shape, group, x_shape = ctx.conf
        shape = list(slab_shape)
        shape[axis] = p.shards * p.rows + 1
        sums = g.new_zeros(shape, dtype=torch.float32)
        dx = g.new_zeros(x_shape, dtype=torch.float32)
        at = 0
        for kind, p_lo, p_hi in pieces:
            piece = g.narrow(axis, at, p_hi - p_lo).float()
            at += p_hi - p_lo
            if kind == "own":
                dx.narrow(axis, p_lo - a, p_hi - p_lo).add_(piece)
            else:
                sums.index_add_(axis, _fetch_index(p, p_lo, p_hi, g.device),
                                piece)
        sums = sums.narrow(axis, 0, p.shards * p.rows).contiguous()
        dist.all_reduce(sums, group=group)
        mine = sums.narrow(axis, index * p.rows, p.rows)
        n = x_shape[axis]
        if p.whole:
            dx.add_(mine.narrow(axis, 0, n))
        else:
            k = min(p.t, n)
            dx.narrow(axis, 0, k).add_(mine.narrow(axis, 0, k))
            dx.narrow(axis, n - k, k).add_(mine.narrow(axis, 2 * p.t - k, k))
        return dx.to(g.dtype), None, None, None, None, None, None


def exchange(x: torch.Tensor, *, axis: int, global_size: int,
             need: Sequence[Range], group=None) -> torch.Tensor:
    """This rank's rows ``need[rank]`` of the global tensor whose shards the
    ranks of ``group`` hold along ``axis`` (see the module docstring);
    differentiable."""
    shards = dist.get_world_size(group)
    index = dist.get_rank(group)
    need = tuple((int(lo), int(hi)) for lo, hi in need)
    if len(need) != shards:
        raise ValueError(f"need lists {len(need)} ranks; the group has "
                         f"{shards}")
    axis = axis % x.dim()
    return _Exchange.apply(x, axis, need, group, index, shards,
                           int(global_size))


exchange.moved = 0
exchange.held = 0


def gather(x: torch.Tensor, *, axis: int, global_size: int, group=None
           ) -> torch.Tensor:
    """The whole global tensor on every rank of ``group`` from the shards
    they hold along ``axis`` (one ``all_gather`` of shards padded to the
    longest). Not differentiable."""
    shards = dist.get_world_size(group)
    axis = axis % x.dim()
    sizes = [owned(global_size, shards, r) for r in range(shards)]
    longest = max(hi - lo for lo, hi in sizes)
    slab = _pad_rows(x, axis, 0, longest - x.shape[axis]).contiguous()
    parts = [torch.empty_like(slab) for _ in range(shards)]
    dist.all_gather(parts, slab, group=group)
    return torch.cat([part.narrow(axis, 0, hi - lo)
                      for part, (lo, hi) in zip(parts, sizes)], dim=axis)


# the sharded axes of NCHW / NCDHW activations
IMAGE_AXIS = -2      # H: image sharding
DISPARITY_AXIS = -3  # D of the 3D volumes: disparity sharding


@dataclasses.dataclass(frozen=True)
class ShardedAxis:
    """The sharding of the block in force: ``group``'s ranks each hold
    their rows (`owned`) of tensor axis ``axis`` (negative), whose global
    size is ``global_size``; this rank is ``index`` of ``shards``."""

    group: object
    axis: int
    global_size: int
    index: int
    shards: int

    def owned(self, global_size: Optional[int] = None) -> Range:
        """This rank's rows [lo, hi) of an axis of ``global_size`` (default
        the block's)."""
        return owned(self.global_size if global_size is None
                     else global_size, self.shards, self.index)


_SHARDED = contextvars.ContextVar("redtail_torch_sharded_axis", default=None)


@contextlib.contextmanager
def sharded_axis(group, axis: int, global_size: int):
    """Run the block's convs (and soft-argmins over ``axis``) on this
    rank's shard of ``axis`` (`IMAGE_AXIS` or `DISPARITY_AXIS`) of global
    size ``global_size`` among the ranks of ``group`` (see
    `ops/convolution.py`)."""
    if axis not in (IMAGE_AXIS, DISPARITY_AXIS):
        raise ValueError(f"axis must be {IMAGE_AXIS} (H) or "
                         f"{DISPARITY_AXIS} (D), got {axis}")
    token = _SHARDED.set(ShardedAxis(group, axis, int(global_size),
                                     dist.get_rank(group),
                                     dist.get_world_size(group)))
    try:
        yield
    finally:
        _SHARDED.reset(token)


def current_sharding() -> Optional[ShardedAxis]:
    """The `ShardedAxis` of the enclosing `sharded_axis` block, or None."""
    return _SHARDED.get()


@contextlib.contextmanager
def sharded_extent(spatial: Sequence[int]):
    """Inside a `sharded_axis` block: the block's layers take inputs of
    global spatial extent ``spatial`` ((H, W) or (D, H, W)); the sharded
    axis's global size is read from it. Where ``spatial`` has no such axis
    (a 2D map under disparity sharding) the block runs unsharded. Outside
    a sharded block: nothing."""
    sh = _SHARDED.get()
    if sh is None:
        yield
        return
    i = len(spatial) + sh.axis
    token = _SHARDED.set(None if i < 0 else dataclasses.replace(
        sh, global_size=int(spatial[i])))
    try:
        yield
    finally:
        _SHARDED.reset(token)


def image_sharding() -> Optional[ShardedAxis]:
    """The `ShardedAxis` in force where it shards the image rows (H), else
    None: what the ops on other layouts (the packed head's NDHWC slots,
    the emission's NHWC maps, dfold) read."""
    sh = _SHARDED.get()
    return sh if sh is not None and sh.axis == IMAGE_AXIS else None


def empty_shard(src: torch.Tensor, shape, dtype) -> torch.Tensor:
    """A shard with no rows, tied to ``src`` in the autograd graph."""
    return (src.sum() * 0).to(dtype).expand(shape)


def window_size(n: int, k: int, s: int = 1, pads: Tuple[int, int] = (0, 0),
                dil: int = 1) -> int:
    """The output size of a window of ``k`` taps at stride ``s`` over ``n``
    rows dilated by ``dil`` (lhs dilation) and padded by ``pads``."""
    return ((n - 1) * dil + 1 + pads[0] + pads[1] - k) // s + 1


def window_rows(a: int, b: int, *, k: int, s: int = 1, lo: int = 0,
                dil: int = 1) -> Range:
    """The input rows ``[i0, i1)`` that output rows ``[a, b)`` (not empty)
    of that window read, ``lo`` its low pad; rows outside the axis
    included (the exchange gives them as zeros)."""
    first, last = a * s - lo, (b - 1) * s - lo + k - 1
    return -(-first // dil), last // dil + 1


def fetch(x: torch.Tensor, sh: ShardedAxis, axis: int, *, global_size: int,
          out_size: int, need) -> Tuple[torch.Tensor, Range, Range]:
    """Each rank of ``sh`` owns rows ``[a, b)`` of an output axis of
    ``out_size`` (`owned`) and reads rows ``need(a, b)`` of ``axis`` of
    ``x``, whose global size is ``global_size`` (none where it owns none):
    one `exchange`. Returns (the slab, (a, b), the rows it holds)."""
    def rows(r):
        a, b = owned(out_size, sh.shards, r)
        return need(a, b) if b > a else (0, 0)

    slab = exchange(x, axis=axis, global_size=global_size,
                    need=[rows(r) for r in range(sh.shards)], group=sh.group)
    return slab, owned(out_size, sh.shards, sh.index), rows(sh.index)


def halo_rows(x: torch.Tensor, sh: ShardedAxis, axis: int, *,
              global_size: int, k: int, s: int = 1,
              pads: Tuple[int, int] = (0, 0), dil: int = 1
              ) -> Tuple[torch.Tensor, Range, Range]:
    """`fetch` for a window op (``k`` taps, stride ``s``, global pads
    ``pads``, lhs dilation ``dil``) along ``axis`` of ``x``: each rank owns
    output rows ``[a, b)`` of the op's global output. Returns (the slab,
    the pads that make the op over the slab give exactly rows [a, b),
    (a, b)); a rank with no rows gets an empty slab and pads (0, 0)."""
    slab, (a, b), (i0, i1) = fetch(
        x, sh, axis, global_size=global_size,
        out_size=window_size(global_size, k, s, pads, dil),
        need=lambda a, b: window_rows(a, b, k=k, s=s, lo=pads[0], dil=dil))
    if b == a:
        return slab, (0, 0), (a, b)
    first, last = a * s - pads[0], (b - 1) * s - pads[0] + k - 1
    return slab, (i0 * dil - first, last - (i1 - 1) * dil), (a, b)
