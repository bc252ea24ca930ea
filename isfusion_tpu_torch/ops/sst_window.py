"""K17: SST's sparse window partition and token moves (counterpart of
``isfusion_tpu/models/sst/sst_sparse.py``: ``:39 get_window_coors``, ``:79
bucketize_shift``, ``:142 window2flat``, ``:329 _rebind`` and the canvas
scatter of ``:257 SSTv2Sparse``, with ``ops/scatter.py:102 group_ranks``
and ``ops/sparse.py:162 unique_sorted_ids``).

``sst_partition`` gives one shift variant's partition of a batch of
sparse voxels (``WindowPartition``): each voxel's window id, in-window
(z, y, x), rank in its window (increasing voxel index), its window's
voxel count, drop level (the last level whose ``drop_range`` holds the
count) and whether it is kept (rank < the level's ``max_tokens`` and its
window within the level's table), its window's slot in the level's table
(the level's window ids ascending, the lowest kept past the cap) and its
token row, plus the maps that the moves read: each token's voxel and
each canvas cell's voxel. ``flat_to_window`` (``_rebind``: every level's
buckets in one launch, zeros where no token sits), ``window_to_flat``
(``window2flat``: kept rows take their token, the rest pass through) and
``flat_to_canvas`` (``recover_bev``: valid rows at ``y * sx + x``, other
cells zero) move rows by it, with gradients.

A level's buckets are (B, cap_l, T_l, C) with cap_l = min(win_caps[l],
NW), NW the windows of a sample ((ceil(s / w) + 1) an axis): a level
cannot hold more windows than a sample has, and the JAX package's caps
(V // lo, or V) never bind below that, so the buckets hold what the JAX
package's (win_caps[l], T_l, C) buckets hold in their first cap_l rows
(the rest are empty) without a host synchronisation.

On a CPU tensor each function takes its plain PyTorch version (``*_ref``);
on a CUDA tensor it launches ``csrc/sst_window.cu`` (``sst_partition``,
``sst_move``) or raises. The partition's outputs equal the plain
version's bit for bit; a move copies rows, so its outputs and gradients
equal plain autograd's. Voxel coordinates are unique within a sample (as
a voxelizer gives them; the JAX package's ``.at[].set`` order is undefined
on duplicates) and a valid voxel lies inside ``sparse_shape``; the drop
ranges do not overlap (a window has one level).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .pointnet_ops import _call, _fn, _on_card
from .scatter import group_ranks

INT_MAX = 2 ** 31 - 1
# the kernel's limit on drop levels (a move reads or writes a tensor a
# level)
MAX_LEVELS = 8


# ------------------------------------------------------------ the geometry
def norm_drop_info(drop_info) -> List[dict]:
    """The drop levels in order: a dict of levels (keyed by level, as the
    reference's configs) or a sequence, each ``max_tokens`` and
    ``drop_range``."""
    items = [drop_info[k] for k in sorted(drop_info)] \
        if isinstance(drop_info, dict) else list(drop_info)
    return [dict(max_tokens=int(d["max_tokens"]),
                 drop_range=tuple(int(x) for x in d["drop_range"]))
            for d in items]


def window_geometry(sparse_shape: Sequence[int], window_shape: Sequence[int]
                    ) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """((wx, wy, wz), (nwx, nwy, nwz)): a 2-D window spans the whole z
    axis; ceil(s / w) + 1 windows an axis (``get_window_coors``)."""
    if len(window_shape) == 2:
        w = (int(window_shape[0]), int(window_shape[1]),
             int(sparse_shape[2]))
    else:
        w = tuple(int(x) for x in window_shape[:3])
    n = tuple(math.ceil(int(s) / wi) + 1 for s, wi in zip(sparse_shape, w))
    return w, n


def num_windows(sparse_shape, window_shape) -> int:
    """NW: the window ids of one sample."""
    _, (nx, ny, nz) = window_geometry(sparse_shape, window_shape)
    return nx * ny * nz


def level_caps(drop_info, win_caps, v: int, nw: int) -> List[int]:
    """Each level's table size for V voxels a sample: min(win_caps[l],
    NW), where ``win_caps`` None takes the JAX package's caps (V // lo, V
    where lo is 0)."""
    caps = [v // max(1, d["drop_range"][0]) for d in norm_drop_info(
        drop_info)] if win_caps is None else [int(c) for c in win_caps]
    return [min(max(1, c), nw) for c in caps]


def get_window_coors(coords: torch.Tensor, sparse_shape, window_shape,
                     do_shift: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 3) zyx int32 voxel coordinates -> window id (...,) and
    in-window (z, y, x) (..., 3), int32 (``sst_sparse.py:39``): the grid is
    offset by a full window, or by half a window with ``do_shift`` (not
    along z where the window spans it), then divided (floor, int32)."""
    (wx, wy, wz), (nwx, nwy, nwz) = window_geometry(sparse_shape,
                                                    window_shape)
    sz = int(sparse_shape[2])
    ox, oy, oz = (wx // 2, wy // 2, wz // 2) if do_shift else (wx, wy, wz)
    if sz == wz:
        oz = 0
    c = coords.to(torch.int32)
    cx, cy, cz = c[..., 2] + ox, c[..., 1] + oy, c[..., 0] + oz

    def fdiv(a, d):
        return torch.div(a, d, rounding_mode="floor")

    win = fdiv(cx, wx) * (nwy * nwz) + fdiv(cy, wy) * nwz + fdiv(cz, wz)
    inner = torch.stack([torch.remainder(cz, wz), torch.remainder(cy, wy),
                         torch.remainder(cx, wx)], -1)
    return win.to(torch.int32), inner.to(torch.int32)


class WindowPartition(NamedTuple):
    """One shift variant's partition of B samples of V voxels. (B, V):
    ``win``, ``rank``, ``count``, ``level``, ``slot`` int32, ``keep``
    bool, ``dest`` (the kept voxel's token row among every level's,
    level-major, else -1) and ``cell`` (b * sy * sx + y * sx + x of a
    valid voxel, else -1) int32; ``inner`` (B, V, 3) int32. Flat over
    levels: ``tables`` (each level's (B, cap_l) window ids, INT_MAX past
    its windows), ``tok_src`` (each token's voxel b * V + v, or -1).
    ``cell_src`` (B * sy * sx) each cell's voxel or -1. ``levels``: each
    level's (T_l, cap_l); ``canvas``: (sy, sx)."""
    win: torch.Tensor
    inner: torch.Tensor
    rank: torch.Tensor
    count: torch.Tensor
    level: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    dest: torch.Tensor
    cell: torch.Tensor
    tables: torch.Tensor
    tok_src: torch.Tensor
    cell_src: torch.Tensor
    levels: Tuple[Tuple[int, int], ...]
    canvas: Tuple[int, int]

    def table(self, level: int) -> torch.Tensor:
        """Level ``level``'s (B, cap_l) table of window ids."""
        b = self.win.shape[0]
        off = sum(b * cap for _, cap in self.levels[:level])
        cap = self.levels[level][1]
        return self.tables[off:off + b * cap].view(b, cap)

    def token_valid(self, level: int) -> torch.Tensor:
        """Level ``level``'s (B, cap_l, T_l) bool: a voxel sits there."""
        b = self.win.shape[0]
        off = sum(b * cap * t for t, cap in self.levels[:level])
        t, cap = self.levels[level]
        return (self.tok_src[off:off + b * cap * t] >= 0).view(b, cap, t)


def _partition_args(coords, valid, drop_info) -> List[dict]:
    if coords.dim() != 3 or coords.shape[-1] != 3 or \
            coords.dtype != torch.int32:
        raise TypeError(f"sst_partition: coords must be (B, V, 3) int32, "
                        f"got {tuple(coords.shape)} {coords.dtype}")
    if tuple(valid.shape) != tuple(coords.shape[:2]) or \
            valid.dtype != torch.bool:
        raise TypeError("sst_partition: valid must be (B, V) bool")
    info = norm_drop_info(drop_info)
    if not 1 <= len(info) <= MAX_LEVELS:
        raise ValueError(f"sst_partition: 1 to {MAX_LEVELS} drop levels, got "
                         f"{len(info)}")
    return info


def sst_partition_ref(coords: torch.Tensor, valid: torch.Tensor,
                      sparse_shape, window_shape, drop_info,
                      caps: Sequence[int], do_shift: bool
                      ) -> WindowPartition:
    """Plain PyTorch version of ``sst_partition`` (``caps``: each level's
    table size, ``level_caps``)."""
    info = _partition_args(coords, valid, drop_info)
    b, v = valid.shape
    dev = coords.device
    sx, sy, sz = (int(s) for s in sparse_shape[:3])
    nw = num_windows(sparse_shape, window_shape)
    win, inner = get_window_coors(coords, sparse_shape, window_shape,
                                  do_shift)
    c = coords.long()
    inside = (c >= 0).all(-1) & (c[..., 2] < sx) & (c[..., 1] < sy) & \
        (c[..., 0] < sz)
    if bool((valid & ~inside).any()):
        raise ValueError("sst_partition: a valid voxel lies outside "
                         "sparse_shape")
    # each voxel's window among all samples' (a sample's trash window NW
    # for invalid rows)
    key = torch.where(valid, win.long(), nw) + (nw + 1) * torch.arange(
        b, device=dev)[:, None]
    key = key.reshape(-1)
    gvox = torch.arange(b * v, device=dev)
    flat_valid = valid.reshape(-1)
    rank = group_ranks(key, flat_valid).long()
    counts = torch.bincount(key, minlength=b * (nw + 1))
    count = torch.where(flat_valid, counts[key], 0)
    # each window's level: the last whose range holds its count
    wl = torch.full_like(counts, -1)
    for li, d in enumerate(info):
        lo, hi = d["drop_range"]
        wl = torch.where((counts > 0) & (counts >= lo) & (counts < hi), li,
                         wl)
    level = torch.where(flat_valid, wl[key], -1)
    keep = torch.zeros_like(flat_valid)
    for d in info:
        lo, hi = d["drop_range"]
        keep |= flat_valid & (count >= lo) & (count < hi) & \
            (rank < d["max_tokens"])
    slot = torch.zeros_like(rank)
    dest = torch.full_like(rank, -1)
    tables, tok_src = [], []
    wl2 = wl.view(b, nw + 1)[:, :nw]
    tok_off = 0
    wkey = key.remainder(nw + 1).clamp(max=nw - 1)    # a valid row's window
    bidx = gvox // v if v else gvox
    for li, d in enumerate(info):
        t, cap = d["max_tokens"], int(caps[li])
        flag = (wl2 == li).long()
        s_w = torch.cumsum(flag, 1) - flag            # exclusive, (B, NW)
        in_table = (flag > 0) & (s_w < cap)
        table = torch.full((b, cap), INT_MAX, dtype=torch.int32, device=dev)
        bb, ww = torch.nonzero(in_table, as_tuple=True)
        table[bb, s_w[bb, ww]] = ww.to(torch.int32)
        tables.append(table.reshape(-1))
        s = s_w[bidx, wkey]
        ok = keep & (level == li) & in_table[bidx, wkey]
        keep = torch.where(level == li, ok, keep)
        slot = torch.where(ok, s, slot)
        row = tok_off + (bidx * cap + s) * t + rank.clamp(max=t - 1)
        dest = torch.where(ok, row, dest)
        src = torch.full((b * cap * t,), -1, dtype=torch.int32, device=dev)
        src[row[ok] - tok_off] = gvox[ok].to(torch.int32)
        tok_src.append(src)
        tok_off += b * cap * t
    yx = c[..., 1].reshape(-1) * sx + c[..., 2].reshape(-1)
    cell = torch.where(flat_valid, bidx * (sy * sx) + yx, -1)
    cell_src = torch.full((b * sy * sx,), -1, dtype=torch.int32, device=dev)
    cell_src[cell[flat_valid]] = gvox[flat_valid].to(torch.int32)

    def bv(x):
        return x.view(b, v).to(torch.int32)

    return WindowPartition(
        win, inner, bv(rank), bv(count), bv(level), keep.view(b, v),
        bv(slot), bv(dest), bv(cell), torch.cat(tables), torch.cat(tok_src),
        cell_src, tuple((d["max_tokens"], int(caps[li]))
                        for li, d in enumerate(info)), (sy, sx))


# --------------------------------------------------------------- kernels
def sst_partition(coords: torch.Tensor, valid: torch.Tensor, sparse_shape,
                  window_shape, drop_info, win_caps: Optional[Sequence[int]],
                  do_shift: bool) -> WindowPartition:
    """K17-part: one shift variant's ``WindowPartition`` of (B, V, 3) zyx
    int32 voxel coordinates and their (B, V) bool mask, each level's table
    ``level_caps(drop_info, win_caps, V, NW)`` windows (``win_caps`` None:
    the JAX package's default caps)."""
    info = _partition_args(coords, valid, drop_info)
    b, v = valid.shape
    nw = num_windows(sparse_shape, window_shape)
    caps = level_caps(info, win_caps, v, nw)
    if not _on_card("sst_partition", coords, valid):
        return sst_partition_ref(coords, valid, sparse_shape, window_shape,
                                 info, caps, do_shift)
    (wx, wy, wz), _ = window_geometry(sparse_shape, window_shape)
    sx, sy, sz = (int(s) for s in sparse_shape[:3])
    coords, valid = coords.contiguous(), valid.contiguous()

    def ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device=coords.device)

    win, rank, count, level, slot, dest, cell = (ints(b, v)
                                                 for _ in range(7))
    inner = ints(b, v, 3)
    keep = torch.empty((b, v), dtype=torch.bool, device=coords.device)
    tables = ints(sum(b * c for c in caps))
    tok_src = ints(sum(b * c * d["max_tokens"] for c, d in zip(caps, info)))
    cell_src = ints(b * sy * sx)
    words = _fn("sst_partition_scratch")(b, v, nw, len(info))
    scratch = ints(max(words, 1))
    levels = [x for c, d in zip(caps, info)
              for x in (*d["drop_range"], d["max_tokens"], c)]
    _call("sst_partition", coords, coords, valid, win, inner, rank, count,
          level, keep, slot, dest, cell, tables, tok_src, cell_src, scratch,
          b, v, sx, sy, sz, wx, wy, wz, int(bool(do_shift)), len(info),
          *levels)
    return WindowPartition(
        win, inner, rank, count, level, keep, slot, dest, cell, tables,
        tok_src, cell_src, tuple((d["max_tokens"], c)
                                 for c, d in zip(caps, info)), (sy, sx))


# ----------------------------------------------------------------- moves
def _gather_rows_ref(src: torch.Tensor, idx: torch.Tensor,
                     pass_: Optional[torch.Tensor] = None,
                     complement: bool = False) -> torch.Tensor:
    """Rows ``out[r] = src[idx[r]]`` where idx[r] >= 0, else ``pass_[r]``
    (zeros without one); with ``complement``, zeros where idx[r] >= 0,
    else ``pass_[r]``: the kernel's one function, plain."""
    sel = (idx >= 0)[:, None]
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    if complement:
        return torch.where(sel, zero, pass_)
    rows = src[idx.long().clamp(min=0)] if src.shape[0] else \
        src.new_zeros((idx.shape[0],) + tuple(src.shape[1:]))
    return torch.where(sel, rows, zero if pass_ is None else pass_)


def _level_views(flat: torch.Tensor, part: WindowPartition
                 ) -> List[torch.Tensor]:
    b, c = part.win.shape[0], flat.shape[-1]
    out, off = [], 0
    for t, cap in part.levels:
        out.append(flat[off:off + b * cap * t].view(b, cap, t, c))
        off += b * cap * t
    return out


def flat_to_window_ref(feats: torch.Tensor, part: WindowPartition
                       ) -> List[torch.Tensor]:
    """Plain version of ``flat_to_window``."""
    src = feats.reshape(-1, feats.shape[-1])
    return _level_views(_gather_rows_ref(src, part.tok_src), part)


def window_to_flat_ref(tokens: Sequence[torch.Tensor], part: WindowPartition,
                       feats: torch.Tensor) -> torch.Tensor:
    """Plain version of ``window_to_flat``."""
    c = feats.shape[-1]
    src = torch.cat([t.reshape(-1, c) for t in tokens])
    return _gather_rows_ref(src, part.dest.reshape(-1), feats.reshape(
        -1, c)).view(feats.shape)


def flat_to_canvas_ref(x: torch.Tensor, part: WindowPartition
                       ) -> torch.Tensor:
    """Plain version of ``flat_to_canvas``."""
    b, c = x.shape[0], x.shape[-1]
    return _gather_rows_ref(x.reshape(-1, c), part.cell_src).view(
        b, *part.canvas, c)


def _move(idx: torch.Tensor, src: Sequence[torch.Tensor], src_rows: int,
          dst: Sequence[torch.Tensor], pass_: Optional[torch.Tensor] = None,
          complement: bool = False) -> None:
    """One ``sst_move`` launch: len(idx) rows of the (segmented) ``dst``
    from the (segmented) ``src`` rows, every tensor contiguous rows of one
    type and width."""
    row_bytes = dst[0].shape[-1] * dst[0].element_size()

    def segs(ts):
        out, first = [], 0
        for t in ts:
            out += [t, first]
            first += t.numel() // t.shape[-1]
        return out

    _call("sst_move", idx, idx.numel(), row_bytes, idx, pass_,
          int(complement), src_rows, len(src), len(dst), *segs(src),
          *segs(dst))


def _contiguous(ts):
    return [t if t.is_contiguous() else t.contiguous() for t in ts]


def _to_window(feats, part) -> List[torch.Tensor]:
    b, c = part.win.shape[0], feats.shape[-1]
    outs = [feats.new_empty((b, cap, t, c)) for t, cap in part.levels]
    _move(part.tok_src, [feats], feats.numel() // c, outs)
    return outs


def _to_flat(tokens, part, feats) -> torch.Tensor:
    out = torch.empty_like(feats)
    _move(part.dest, tokens, part.tok_src.numel(), [out], feats)
    return out


def _to_canvas(x, part) -> torch.Tensor:
    out = x.new_empty((x.shape[0], *part.canvas, x.shape[-1]))
    _move(part.cell_src, [x], x.numel() // x.shape[-1], [out])
    return out


class _FlatToWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, part):
        ctx.part, ctx.c, ctx.dtype = part, feats.shape[-1], feats.dtype
        return tuple(_to_window(feats, part))

    @staticmethod
    def backward(ctx, *grads):
        part = ctx.part
        grads = _contiguous([g if g is not None else torch.zeros(
            (part.win.shape[0], cap, t, ctx.c), dtype=ctx.dtype,
            device=part.win.device) for g, (t, cap) in zip(grads,
                                                           part.levels)])
        b, v = part.win.shape
        out = grads[0].new_empty((b, v, ctx.c))
        _move(part.dest, grads, part.tok_src.numel(), [out])
        return out, None


class _WindowToFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, part, *tokens):
        ctx.part = part
        return _to_flat(tokens, part, feats)

    @staticmethod
    def backward(ctx, g):
        part = ctx.part
        g = g.contiguous()
        gf = None
        if ctx.needs_input_grad[0]:
            # the rows that were not kept: g as it is, zeros where kept
            gf = torch.empty_like(g)
            _move(part.dest, [g], part.tok_src.numel(), [gf], g, True)
        gt = _to_window(g, part) if any(ctx.needs_input_grad[2:]) \
            else [None] * len(part.levels)
        return (gf, None, *gt)


class _FlatToCanvas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        ctx.part = part
        return _to_canvas(x, part)

    @staticmethod
    def backward(ctx, g):
        part = ctx.part
        g = g.contiguous()
        b, v = part.win.shape
        out = g.new_empty((b, v, g.shape[-1]))
        _move(part.cell, [g], g.numel() // g.shape[-1], [out])
        return out, None


def _move_args(name: str, part: WindowPartition, rows, tokens=()) -> None:
    """Raise unless ``rows`` (B, V, C) and ``tokens`` (each level's (B,
    cap_l, T_l, C)) are of the partition's shapes, one type and width."""
    b, v = part.win.shape
    for t in (rows, *tokens):
        if t.dtype != rows.dtype or t.shape[-1] != rows.shape[-1]:
            raise TypeError(f"{name}: rows of one type and width, got "
                            f"{t.dtype} {tuple(t.shape)}")
    shapes = [tuple(t.shape[:3]) for t in tokens]
    if tuple(rows.shape[:2]) != (b, v) or (tokens and shapes != [
            (b, cap, t) for t, cap in part.levels]):
        raise ValueError(f"{name}: rows {tuple(rows.shape)} and tokens "
                         f"{shapes} do not fit the partition's (B, V) = "
                         f"{(b, v)} and levels {part.levels}")


def _grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flat_to_window(feats: torch.Tensor, part: WindowPartition
                   ) -> List[torch.Tensor]:
    """K17-move op 0 (``_rebind``): (B, V, C) voxel rows -> each level's
    (B, cap_l, T_l, C) buckets, a kept voxel's row at its token, zeros
    elsewhere; one launch for every level."""
    _move_args("flat_to_window", part, feats)
    if not _on_card("flat_to_window", feats, part.tok_src):
        return flat_to_window_ref(feats, part)
    feats = feats.contiguous()
    if _grad(feats):
        return list(_FlatToWindow.apply(feats, part))
    return _to_window(feats, part)


def window_to_flat(tokens: Sequence[torch.Tensor], part: WindowPartition,
                   feats: torch.Tensor) -> torch.Tensor:
    """K17-move op 1 (``window2flat``): each kept voxel's row from its
    token of ``tokens`` (each level's (B, cap_l, T_l, C)), the other rows
    of ``feats`` (B, V, C) as they are."""
    _move_args("window_to_flat", part, feats, tokens)
    if not _on_card("window_to_flat", feats, part.dest, *tokens):
        return window_to_flat_ref(tokens, part, feats)
    feats, tokens = feats.contiguous(), _contiguous(tokens)
    if _grad(feats, *tokens):
        return _WindowToFlat.apply(feats, part, *tokens)
    return _to_flat(tokens, part, feats)


def flat_to_canvas(x: torch.Tensor, part: WindowPartition) -> torch.Tensor:
    """K17-move op 2 (``recover_bev``): (B, V, C) rows of the partition's
    valid voxels -> the (B, sy, sx, C) canvas at y * sx + x, zeros
    elsewhere."""
    _move_args("flat_to_canvas", part, x)
    if not _on_card("flat_to_canvas", x, part.cell_src):
        return flat_to_canvas_ref(x, part)
    x = x.contiguous()
    if _grad(x):
        return _FlatToCanvas.apply(x, part)
    return _to_canvas(x, part)
