"""RoI-aware mean pooling (counterpart of ``isfusion_tpu/models/roi_heads/
part_aggregation_roi_head.py:26 roiaware_pool``; the reference's
``roiaware_pool3d`` in its mean mode) — K16, forward and backward.

``roiaware_pool(rois (B, R, 7+), centers (B, V, 3), feats (B, V, C), mask
(B, V), grid_size G) -> (B, R, G, G, G, C)`` float32: for each RoI, the
mean of the features of the valid voxels inside it that fall in each of
its G^3 cells (``ops/box_ops.py:box_local_uvw``; cell = clip(trunc(u G),
0, G - 1) per axis), 0 for an empty cell. The gradient reaches ``feats``
only: the RoIs and centres are detached, the cells integers.

On a CPU tensor it takes its plain PyTorch version (``roiaware_pool_ref``:
the pairwise (V, R) transform and a segment sum over the inside pairs, in
voxel order); on a CUDA tensor ``RoIAwarePoolFunction``, whose forward and
backward are ``csrc/roiaware_pool.cu`` (no float atomics; two calls agree
bit for bit; the (r, v) -> cell map equals the plain version's on the
card: the wrapper hands the kernel torch's cos and sin of the yaws), or it
raises. The forward's first launch writes a membership bitmap and the
inside pairs' cells behind an exact cut (``roiaware_cut_ref`` mirrors the
cut; ``roiaware_bitmap_ref`` the bitmap), which the second launch and the
backward read. ``roiaware_pool_state`` gives the forward's cell counts and
its list of inside voxels, for checks.
"""
from __future__ import annotations

import torch

from . import cuda_build
from .box_ops import box_local_uvw, box_trig

# float32 operations of the cut a pair (the vertical slab: 2 subtractions,
# an absolute value, a comparison; the BEV circle: 2 subtractions, 2
# products, a sum, a comparison), of the exact test behind it (4 products
# and 2 sums for the rotation, 3 divisions and 3 sums, 6 comparisons) and
# of a cell (3 products)
ROIAWARE_CUT_OPS = 10
ROIAWARE_EXACT_OPS = 18
ROIAWARE_CELL_OPS = 3
# the cut's slack (csrc/roiaware_pool.cu says why no inside pair is cut)
ROIAWARE_CUT_REL, ROIAWARE_CUT_ABS = 1.0 + 1e-4, 1e-3
# shared memory a block may use; the pool kernel's 32 warps each count the
# G^3 cells of their part of a RoI's list, beside each cell's count and
# start and 256 bytes of its own; a backward block stages 128 RoIs' words,
# the cells of their pairs and each warp's pairs in order (25,088 bytes)
# and its 32 rows of C + 1 floats
ROIAWARE_SMEM_BYTES = 227 * 1024
ROIAWARE_POOL_WARPS = 32
ROIAWARE_BWD_STATIC_BYTES = 128 * (4 + 32 * 4) + 8 * 128 * 4 * 2


def _check(rois, centers, feats, mask, grid_size):
    b = rois.shape[0] if rois.dim() == 3 else -1
    v = centers.shape[1] if centers.dim() == 3 else -1
    if rois.dim() != 3 or rois.shape[-1] < 7 or \
            tuple(centers.shape) != (b, v, 3) or feats.dim() != 3 or \
            tuple(feats.shape[:2]) != (b, v) or tuple(mask.shape) != (b, v):
        raise ValueError(
            f"roiaware_pool: rois (B, R, 7+), centers (B, V, 3), feats (B, "
            f"V, C), mask (B, V); got {tuple(rois.shape)}, "
            f"{tuple(centers.shape)}, {tuple(feats.shape)}, "
            f"{tuple(mask.shape)}")
    if len({rois.device, centers.device, feats.device, mask.device}) != 1:
        raise ValueError("roiaware_pool: inputs on different devices")
    if int(grid_size) < 1:
        raise ValueError(f"roiaware_pool: grid_size {grid_size} < 1")


def roiaware_cells_ref(rois: torch.Tensor, centers: torch.Tensor,
                       mask: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B, R, V) int64: the cell of each valid voxel inside each RoI, -1
    elsewhere (plain PyTorch)."""
    g = int(grid_size)
    uvw, inside = box_local_uvw(rois[..., :7].float(), centers.float())
    inside = inside & mask.bool()[..., None]
    ijk = (uvw * g).to(torch.int32).clamp(0, g - 1).long()
    cell = (ijk[..., 0] * g + ijk[..., 1]) * g + ijk[..., 2]
    return torch.where(inside, cell, -1).transpose(1, 2)


def roiaware_cut_ref(rois: torch.Tensor, centers: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """(B, R, V) bool: the valid (voxel, RoI) pairs that pass the forward
    kernel's cut, in its float32 arithmetic: |rz| <= (dz' 0.5) (1 + 1e-4) +
    1e-3 and rx^2 + ry^2 <= (0.5 hypot(dx', dy') (1 + 1e-4) + 1e-3)^2, with
    rx, ry, rz as ``box_local_uvw`` computes them and d' = max(d, 1e-3); a
    NaN passes. Only these pairs run the exact test; every inside pair is
    among them."""
    r = rois[..., :7].float()
    p = centers.float()
    dims = r[..., 3:6].clamp_min(1e-3)
    zlim = dims[..., 2] * 0.5 * ROIAWARE_CUT_REL + ROIAWARE_CUT_ABS
    lim = 0.5 * torch.hypot(dims[..., 0], dims[..., 1]) * ROIAWARE_CUT_REL \
        + ROIAWARE_CUT_ABS
    rx = p[:, None, :, 0] - r[..., 0, None]
    ry = p[:, None, :, 1] - r[..., 1, None]
    rz = (p[:, None, :, 2] - r[..., 2, None]) - r[..., 5, None] * 0.5
    d2 = rx * rx + ry * ry
    through = ~(rz.abs() > zlim[..., None]) & ~(d2 > (lim * lim)[..., None])
    return through & mask.bool()[:, None, :]


def roiaware_bitmap_ref(cells: torch.Tensor) -> torch.Tensor:
    """(B, R, ceil(V / 32)) int32 membership words of a cell map
    (``roiaware_cells_ref``), the forward kernel's layout: bit i of word w
    is set where voxel 32 w + i is inside the RoI."""
    b, r, v = cells.shape
    w = -(-v // 32)
    inside = torch.zeros((b, r, w * 32), dtype=torch.int64,
                         device=cells.device)
    inside[..., :v] = (cells >= 0).long()
    shifts = torch.arange(32, device=cells.device)
    words = (inside.view(b, r, w, 32) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()


def roiaware_list_ref(cells: torch.Tensor, grid_size: int):
    """(counts (B, R, G^3) int32, entries (B, R, V) int64) of a cell map
    (``roiaware_cells_ref``): each RoI's cell counts, and its inside voxels
    as v G^3 + cell in voxel order, then -1 (the forward kernel's list)."""
    g3 = int(grid_size) ** 3
    inside = cells >= 0
    counts = torch.zeros(cells.shape[:2] + (g3,), dtype=torch.int32,
                         device=cells.device).scatter_add_(
                             -1, cells.clamp_min(0), inside.int())
    v = torch.arange(cells.shape[-1], device=cells.device)
    entries = torch.where(inside, v * g3 + cells, -1)
    order = (~inside).to(torch.uint8).argsort(dim=-1, stable=True)
    return counts, entries.gather(-1, order)


def roiaware_pool_ref(rois: torch.Tensor, centers: torch.Tensor,
                      feats: torch.Tensor, mask: torch.Tensor,
                      grid_size: int) -> torch.Tensor:
    """Plain PyTorch version of ``roiaware_pool``: the sums run over the
    inside (voxel, RoI) pairs in voxel order, autograd gives the
    backward."""
    _check(rois, centers, feats, mask, grid_size)
    g = int(grid_size)
    b, r = rois.shape[:2]
    c = feats.shape[-1]
    g3 = g ** 3
    cells = roiaware_cells_ref(rois, centers, mask, g).transpose(1, 2)
    bi, vi, ri = torch.nonzero(cells >= 0, as_tuple=True)
    seg = (bi * r + ri) * g3 + cells[bi, vi, ri]
    total = torch.zeros((b * r * g3, c), dtype=torch.float32,
                        device=feats.device).index_add(
                            0, seg, feats.float()[bi, vi])
    cnt = torch.bincount(seg, minlength=b * r * g3).float()
    pooled = total / cnt.clamp_min(1.0)[:, None]
    return pooled.view(b, r, g, g, g, c)


def _launch(op: int, rois, trig, centers, mask, inp, counts, out, scratch,
            bits, cells, b: int, r: int, v: int, c: int, g: int) -> None:
    lib = cuda_build.load("roiaware_pool")
    stream = torch.cuda.current_stream(counts.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.roiaware_pool(op, ptr(rois), ptr(trig), ptr(centers),
                            ptr(mask), ptr(inp), ptr(counts), ptr(out),
                            ptr(scratch), ptr(bits), ptr(cells), b, r, v, c,
                            g, stream)
    if err != 0:
        raise RuntimeError(f"roiaware_pool: kernel launch failed with CUDA "
                           f"error {err}")


def roiaware_smem_bytes(grid_size: int, channels: int) -> int:
    """Shared memory of K16's largest block: the pool kernel's cell counts
    and starts, or the backward's chunk and staged rows."""
    g3 = int(grid_size) ** 3
    return max((ROIAWARE_POOL_WARPS + 2) * g3 * 4 + 256,
               ROIAWARE_BWD_STATIC_BYTES + 32 * (int(channels) + 1) * 4)


def _kernel_args(rois, centers, mask, grid_size, channels):
    """Contiguous float32 rows, the yaws' cos and sin, and the limits of
    the kernel checked."""
    g = int(grid_size)
    v = centers.shape[1]
    if v * g ** 3 >= 2 ** 31:
        raise ValueError(f"roiaware_pool: V * G^3 = {v * g ** 3} must stay "
                         f"below 2^31")
    smem = roiaware_smem_bytes(g, channels)
    if smem > ROIAWARE_SMEM_BYTES:
        raise ValueError(f"roiaware_pool: G = {g}, C = {channels} need "
                         f"{smem} bytes of a block's shared memory")
    rois = rois[..., :7].float().contiguous()
    return rois, box_trig(rois).contiguous(), \
        centers.float().contiguous(), mask.bool().contiguous()


def _forward(rois, trig, centers, feats, mask, g: int):
    """(pooled, counts, scratch, bits, cells): two launches, the cut and
    tests writing ``bits`` and the inside pairs' ``cells``, then the lists,
    counts and sums."""
    b, r = rois.shape[:2]
    v, c = feats.shape[1:]
    feats = feats.contiguous()
    dev = feats.device
    pooled = torch.empty((b, r, g, g, g, c), dtype=torch.float32,
                         device=dev)
    counts = torch.empty((b, r, g ** 3), dtype=torch.int32, device=dev)
    # each RoI's list in voxel order, then the same voxels sorted by cell
    scratch = torch.empty((b * r, 2 * v), dtype=torch.int32, device=dev)
    bits = torch.empty((b, r, -(-v // 32)), dtype=torch.int32, device=dev)
    # each inside pair's cell (uint16 in the kernel); the rest unwritten
    cells = torch.empty((b, r, v), dtype=torch.int16, device=dev)
    if b * r * v and c:
        _launch(0, rois, trig, centers, mask, feats, counts, pooled, scratch,
                bits, cells, b, r, v, c, g)
        cuda_build.LAUNCHES["roiaware_pool"] += 2
    else:
        pooled.zero_()
        counts.zero_()
    return pooled, counts, scratch, bits, cells


class RoIAwarePoolFunction(torch.autograd.Function):
    """K16 forward and backward (``csrc/roiaware_pool.cu``): saves the
    forward's cell counts, its membership bitmap and the inside pairs'
    cells."""

    @staticmethod
    def forward(ctx, rois, trig, centers, feats, mask, grid_size):
        g = int(grid_size)
        pooled, counts, _, bits, cells = _forward(rois, trig, centers,
                                                  feats.float(), mask, g)
        ctx.save_for_backward(counts, bits, cells)
        ctx.grid_size, ctx.channels = g, feats.shape[-1]
        return pooled

    @staticmethod
    def backward(ctx, dpooled):
        counts, bits, cells = ctx.saved_tensors
        b, r, v = cells.shape
        c, g = ctx.channels, ctx.grid_size
        if b * r * v and c:
            dfeats = torch.empty((b, v, c), dtype=torch.float32,
                                 device=cells.device)
            _launch(1, None, None, None, None, dpooled.float().contiguous(),
                    counts, dfeats, None, bits, cells, b, r, v, c, g)
            cuda_build.LAUNCHES["roiaware_pool"] += 1
        else:
            dfeats = torch.zeros((b, v, c), dtype=torch.float32,
                                 device=cells.device)
        return None, None, None, dfeats, None, None


def roiaware_pool(rois: torch.Tensor, centers: torch.Tensor,
                  feats: torch.Tensor, mask: torch.Tensor,
                  grid_size: int) -> torch.Tensor:
    """(B, R, G, G, G, C) float32 mean-pooled features of the voxels inside
    each RoI (module docstring); two kernel launches forward, one
    backward, no host synchronisation."""
    _check(rois, centers, feats, mask, grid_size)
    if rois.device.type == "cpu":
        return roiaware_pool_ref(rois, centers, feats, mask, grid_size)
    if rois.device.type != "cuda":
        raise RuntimeError(f"roiaware_pool: no kernel for {rois.device}")
    rois, trig, centers, mask = _kernel_args(rois, centers, mask, grid_size,
                                             feats.shape[-1])
    return RoIAwarePoolFunction.apply(rois, trig, centers, feats.float(),
                                      mask, int(grid_size))


def roiaware_pool_state(rois: torch.Tensor, centers: torch.Tensor,
                        feats: torch.Tensor, mask: torch.Tensor,
                        grid_size: int):
    """(pooled (B, R, G, G, G, C), counts (B, R, G^3) int32, entries (B, R,
    V) int64), no gradient, for checks: K16's forward with its cell counts
    and each RoI's list of inside voxels (v G^3 + cell in the order the
    kernel compacted them, then -1) on a CUDA tensor; the plain version's
    (``roiaware_list_ref``) on a CPU tensor."""
    _check(rois, centers, feats, mask, grid_size)
    g = int(grid_size)
    if rois.device.type == "cpu":
        counts, entries = roiaware_list_ref(
            roiaware_cells_ref(rois, centers, mask, g), g)
        return roiaware_pool_ref(rois, centers, feats, mask, g), counts, \
            entries
    b, r = rois.shape[:2]
    v = centers.shape[1]
    rois, trig, centers, mask = _kernel_args(rois, centers, mask, g,
                                             feats.shape[-1])
    with torch.no_grad():
        pooled, counts, scratch, _, _ = _forward(rois, trig, centers,
                                                 feats.float(), mask, g)
    listed = torch.arange(v, device=rois.device) < counts.sum(
        -1, keepdim=True)
    return pooled, counts, torch.where(
        listed, scratch[:, :v].reshape(b, r, v).long(), -1)


def roiaware_pool_bytes(b: int, r: int, v: int, c: int, g: int,
                        valid_voxels: int, inside_voxels: int) -> int:
    """Least bytes the forward moves on these inputs: the RoIs and the mask
    read once, the centres of the ``valid_voxels``, the features of the
    ``inside_voxels`` (valid and inside some RoI: no other row reaches the
    output), the pooled grid written once."""
    return 4 * b * r * 7 + b * v + 12 * valid_voxels + \
        4 * c * inside_voxels + 4 * b * r * g ** 3 * c


def roiaware_pool_backward_bytes(b: int, r: int, v: int, c: int,
                                 pairs: int, occupied_cells: int) -> int:
    """Least bytes the backward moves on these inputs, given what the
    forward saved: the membership bitmap read once, the cell of each of
    the inside ``pairs`` (2 bytes), dpooled and the count of each of the
    ``occupied_cells`` (no other cell reaches a voxel), dfeats written
    once."""
    return 4 * b * r * -(-v // 32) + 2 * pairs + \
        4 * occupied_cells * (c + 1) + 4 * b * v * c


def roiaware_pool_ops(valid_voxels: int, r: int, cut_pairs: int,
                      pairs: int, c: int, cells: int) -> int:
    """Float32 operations the forward needs on these inputs, as designed:
    the cut for every valid voxel against every RoI of its sample, the
    exact test for the ``cut_pairs`` that pass it (``roiaware_cut_ref``),
    a cell and its C sums for each inside pair, and the C divisions of
    each of the ``cells`` (B R G^3) outputs."""
    return valid_voxels * r * ROIAWARE_CUT_OPS + \
        cut_pairs * ROIAWARE_EXACT_OPS + \
        pairs * (ROIAWARE_CELL_OPS + c) + cells * c


def roiaware_pool_backward_ops(pairs: int, c: int) -> int:
    """Float32 operations the backward needs given the forward's cells:
    dpooled / count and the sum, per inside pair and channel."""
    return pairs * 2 * c


def roiaware_bound_ms(bytes_: int, ops: int, hbm_bytes_per_s: float,
                      f32_ops_per_s: float):
    """(bound ms, 'bytes' or 'operations'): the larger of the two times."""
    t_bytes, t_ops = bytes_ / hbm_bytes_per_s, ops / f32_ops_per_s
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"
