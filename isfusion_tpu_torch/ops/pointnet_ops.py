"""PointNet++ point ops (counterpart of ``isfusion_tpu/ops/pointnet_ops.py``)
— K14: furthest-point sampling, ball query, k nearest neighbours and the
point gathers.

Every op is batched over a leading sample axis: points ``(B, N, 3)``
float32, a validity mask ``(B, N)`` bool (None: all valid), queries
``(B, S, 3)``. The JAX package's ops work on one sample and are vmapped;
the semantics are the same, sample by sample:

- ``furthest_point_sample`` -> (B, S) int32 (``pointnet_ops.py:33``):
  start at the first valid point; running distances start at 1e10 and
  take the minimum of each new squared distance; masked points score
  -1e10; the pick is the lowest index among the largest scores (so
  duplicates and more samples than valid points pick the lowest valid
  index at 0).
- ``ball_query`` -> (B, S, K) int32 idx, (B, S, K) bool valid (``:77``):
  a point is in the ball when its squared distance is ``<= radius ** 2``
  (the square taken in float64 and rounded to float32, as JAX compares a
  float32 array with a Python float); masked points lie at 1e10. The first
  K in-radius points in index order are kept, the other slots repeat the
  first one; a query with no point in its ball takes the nearest point
  (the lowest index among equal distances) with valid False.
- ``knn`` -> (B, S, k) int32 idx, (B, S, k) squared distances (``:66``):
  the k smallest, equal distances in increasing index (``lax.top_k`` of
  the negated distances), masked points at 1e10. ``three_nn`` (``:110``)
  is ``knn`` with k = 3 followed by ``sqrt(max(d2, 1e-10))``.
- ``gather_points`` (B, N, C) x (B, S) -> (B, S, C), ``group_points``
  (B, N, C) x (B, S, K) -> (B, S, K, C) and ``three_interpolate`` (B, M,
  C) x (B, S, 3) idx x (B, S, 3) weights -> (B, S, C), the weighted rows
  summed in slot order (``:61``, ``:105``, ``:118``). Differentiable in
  the features and, for ``three_interpolate``, the weights.

Squared distances are ``(dx * dx + dy * dy) + dz * dz`` with the
differences taken query (or point) minus point, written out term by term
in the plain versions (no reduction whose order a backend chooses) and
rounded step by step in the kernels (no FMA contraction), so that both
give the same float32 values and the same discrete choices.

On a CPU tensor each op takes its plain version (``*_ref``); on a CUDA
tensor it launches its hand-written kernel or raises:
``csrc/furthest_point_sample.cu`` (K14-FPS), ``csrc/ball_query.cu``
(K14-ball: a full scan in index order a query for up to
``BALL_SCAN_MAX_POINTS`` points, past it a cell grid built in the same
call that cuts each query's candidates to the points near its ball),
``csrc/three_nn.cu`` (K14-NN, a warp a query, any k) and
``csrc/point_gather.cu`` (K14-gather: the three gathers forward, their
backward by a CSR of each source row's slots that the same call builds,
and the weights' gradient; a call with no input that needs a gradient
skips autograd). K14-ball's grid and K14-gather's backward build their
lists with one builder (``csrc/stable_lists.cuh``).
The plain versions bound their (S, N) matrices by working on
``QUERY_CHUNK`` queries at a time, with equal results. The index ops have
no gradient; ``knn`` raises when asked for one (its distances are
computed from coordinates that every ported path feeds as data).
``interpolation_weights`` is plain PyTorch on every device (elementwise
over (S, 3)).
"""
from __future__ import annotations

import ctypes
import functools
import struct
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_build

_BIG = 1e10
# queries a plain version handles at once: its (chunk, N) matrices stay
# near 100 MB at the first SA level's 40,000 points
QUERY_CHUNK = 256
# K14-ball scans every point of a sample of up to this many points; a
# larger sample gets the cell grid (csrc/ball_query.cu). On the H100 at
# VoteNet's shapes the grid took SA1 (40,000 points) from 0.60 to 0.040
# device ms; at SA2 (2,048) it saved 0.012 device ms but its six more
# launches cost 35-50 host us a call, and a request is host-bound; SA3,
# SA4 and the aggregation (512-1,024) are no faster by the grid (PERF.md)
BALL_SCAN_MAX_POINTS = 2048
# masked points lie at this squared distance (the plain versions' 1e10)
_MASKED_D2 = float(np.float32(_BIG))
# K14-FPS walks a sample of up to FPS_BLOCK_MAX points in one block (256
# threads, 16 points a thread at most), a larger one in a cluster of 8 or
# 16 blocks of 1,024 threads (``fps_cluster``), which holds up to
# FPS_CLUSTER_POINTS points a block in registers and streams the rest of
# its share from device memory at each pick (the tail route, any N)
FPS_BLOCK_MAX = 4096
FPS_CLUSTER_POINTS = 8192


# ------------------------------------------------------------ plain parts
def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) -> (B, N, M): ``(dx*dx + dy*dy) + dz*dz`` of
    ``a - b``."""
    d = a[:, :, None, :] - b[:, None, :, :]
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def _valid(mask: Optional[torch.Tensor], xyz: torch.Tensor) -> torch.Tensor:
    if mask is None:
        return torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    return mask.bool()


def _masked_distance(query, xyz, mask) -> torch.Tensor:
    d = square_distance(query, xyz)
    return torch.where(mask[:, None, :], d, torch.full((), _BIG,
                                                       device=d.device))


def _radius2(radius: float) -> float:
    """``radius ** 2`` as the float32 that JAX compares against."""
    return float(np.float32(float(radius) ** 2))


@functools.lru_cache(maxsize=64)
def ball_grid_params(radius: float) -> Optional[Tuple[float, float]]:
    """(inv, reach) of K14-ball's cell grid for ``radius``, as float32
    values: ``inv`` the reciprocal of the cell side 33/32 x rho, rho =
    sqrt(r2) (1 + 2^-18) (r2: ``_radius2``; rho bounds every per-axis
    |q - p| that the float32 test admits), ``reach`` rho x inv rounded up;
    None where the grid route does not hold (r2 = 0 or not finite, or r2
    >= 1e10: masked points would be in the ball)."""
    r2 = _radius2(radius)
    if not 0.0 < r2 < _MASKED_D2:
        return None
    rho = float(np.sqrt(np.float64(r2))) * (1.0 + 2.0 ** -18)
    inv = np.float32(1.0 / (rho * 33.0 / 32.0))
    if not (np.isfinite(inv) and inv > 0):
        return None
    reach = np.nextafter(np.float32(rho * float(inv)), np.float32(np.inf))
    return float(inv), float(reach)


def ball_grid_table_bits(n: int) -> int:
    """log2 of K14-ball's hash table: the least power of two >= 2n."""
    return max(0, int(2 * n - 1).bit_length())


def ball_grid_cut(radius: float, xyz: torch.Tensor,
                  query_xyz: torch.Tensor) -> torch.Tensor:
    """Plain version of K14-ball's cut: (B, S, N) bool, True where point
    n's cell lies in query s's cube, the cells that the grid route reads
    (before hashing, which only adds candidates), in the kernel's float32
    arithmetic: a coordinate's cell floor((x - o) * inv) with o the
    sample's first point, clamped to +-2^30; the cube floor(f(q) -+ a)
    with a = (reach + 2^-12) + |f(q)| 2^-18. Every point that the float32
    test admits lies in it (``csrc/ball_query.cu`` argues why)."""
    inv, reach = ball_grid_params(radius)
    f32 = torch.float32
    inv_t = torch.tensor(inv, dtype=f32)
    origin = xyz[:, :1, :]
    lim = 2.0 ** 30

    def coord(x):
        return (x - origin) * inv_t

    def cell(f):
        return torch.floor(f).clamp(-lim, lim)

    fq = coord(query_xyz)
    margin = (torch.tensor(reach, dtype=f32) + torch.tensor(
        2.0 ** -12, dtype=f32)) + fq.abs() * torch.tensor(2.0 ** -18,
                                                           dtype=f32)
    lo, hi = cell(fq - margin), cell(fq + margin)
    cp = cell(coord(xyz))
    inside = (cp[:, None, :, :] >= lo[:, :, None, :]) & \
        (cp[:, None, :, :] <= hi[:, :, None, :])
    return inside.all(-1)


def furthest_point_sample_ref(xyz: torch.Tensor, num_samples: int,
                              mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of K14-FPS: (B, N, 3) -> (B, S) int32."""
    mask = _valid(mask, xyz)
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    dists = torch.full((b, n), _BIG, device=xyz.device)
    low = torch.full((), -_BIG, device=xyz.device)
    last = mask.to(torch.int32).argmax(1)          # the first valid point
    picks = [last]
    for _ in range(1, int(num_samples)):
        d = xyz - xyz[rows, last][:, None, :]
        dx, dy, dz = d.unbind(-1)
        dists = torch.minimum(dists, (dx * dx + dy * dy) + dz * dz)
        last = torch.where(mask, dists, low).argmax(1)
        picks.append(last)
    return torch.stack(picks, 1).to(torch.int32)


def ball_query_ref(radius: float, num_samples: int, xyz: torch.Tensor,
                   query_xyz: torch.Tensor,
                   mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K14-ball: -> (B, S, K) int32 idx, (B, S, K) bool
    valid."""
    mask = _valid(mask, xyz)
    k, n, r2 = int(num_samples), xyz.shape[1], _radius2(radius)
    slots = torch.arange(k, device=xyz.device)
    points = torch.arange(n, device=xyz.device)
    idxs, valids = [], []
    for q in query_xyz.split(QUERY_CHUNK, 1):
        d = _masked_distance(q, xyz, mask)                  # (B, s, N)
        within = d <= r2
        rank = within.to(torch.int32).cumsum(-1)            # 1-based
        keep = within & (rank <= k)
        found = torch.zeros(d.shape[:2] + (k + 1,), dtype=torch.int64,
                            device=d.device)
        found.scatter_(2, torch.where(keep, rank - 1, k).long(),
                       points.expand_as(d))
        found = found[..., :k]
        cnt = rank[..., -1:]
        valid = slots < cnt
        nearest = d.argmin(-1, keepdim=True)
        idx = torch.where(valid, found, torch.where(cnt > 0, found[..., :1],
                                                    nearest))
        idxs.append(idx.to(torch.int32))
        valids.append(valid)
    return torch.cat(idxs, 1), torch.cat(valids, 1)


def knn_ref(k: int, xyz: torch.Tensor, query_xyz: torch.Tensor,
            mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K14-NN: -> (B, S, k) int32 idx, (B, S, k) squared
    distances (a stable sort: equal distances in increasing index)."""
    mask = _valid(mask, xyz)
    idxs, dists = [], []
    for q in query_xyz.split(QUERY_CHUNK, 1):
        d = _masked_distance(q, xyz, mask)
        v, i = torch.sort(d, dim=-1, stable=True)
        idxs.append(i[..., :k].to(torch.int32))
        dists.append(v[..., :k])
    return torch.cat(idxs, 1), torch.cat(dists, 1)


def _rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows at (B, R) indices -> (B, R, C)."""
    return torch.gather(feats, 1, idx.long()[..., None].expand(
        -1, -1, feats.shape[-1]))


def gather_points_ref(feats: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of K14-gather: (B, N, C) x (B, S) -> (B, S, C)."""
    return _rows(feats, idx)


def group_points_ref(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K14-gather: (B, N, C) x (B, S, K) -> (B, S, K, C)."""
    b, s, k = idx.shape
    return _rows(feats, idx.reshape(b, s * k)).reshape(b, s, k, -1)


def three_interpolate_ref(feats: torch.Tensor, idx: torch.Tensor,
                          weight: torch.Tensor) -> torch.Tensor:
    """Plain version of K14-gather: (B, M, C) x (B, S, J) x (B, S, J) ->
    (B, S, C), the J weighted rows summed in slot order."""
    b, s, j = idx.shape
    rows = _rows(feats, idx.reshape(b, s * j)).reshape(b, s, j, -1)
    out = rows[:, :, 0] * weight[..., 0:1]
    for t in range(1, j):
        out = out + rows[:, :, t] * weight[..., t:t + 1]
    return out


def interpolation_weights(dists: torch.Tensor, eps: float = 1e-8
                          ) -> torch.Tensor:
    """Inverse-distance weights over the last axis, the reciprocals summed
    in slot order (plain PyTorch on every device)."""
    recip = 1.0 / dists.clamp_min(eps)
    total = recip[..., 0]
    for t in range(1, recip.shape[-1]):
        total = total + recip[..., t]
    return recip / total[..., None]


# --------------------------------------------------------------- kernels
_RAW_STREAM = None
_FNS = {}
# each thread's argument buffers (the calls' int64 arguments)
_ARGS = threading.local()


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device."""
    global _RAW_STREAM
    if _RAW_STREAM is None:
        _RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _RAW_STREAM(t.device.index)


def _fn(name: str):
    """The ctypes function of kernel ``name``, its argtypes set (built and
    loaded on first use, then cached)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(cuda_build.load(name), name)
    return fn


def _call(name: str, stream_of: torch.Tensor, *args) -> None:
    """One call of ``name`` with its int64 arguments packed into a buffer
    of this thread (tensors as their data pointers, None as 0): the
    generic packer of K15's and K17's calls, which are few and long
    (K14-gather keeps its own unrolled one, ``_gather_call``)."""
    n = len(args)
    bufs = getattr(_ARGS, "bufs", None)
    if bufs is None:
        bufs = _ARGS.bufs = {}
    buf = bufs.get(n)
    if buf is None:
        arr = (ctypes.c_longlong * n)()
        buf = bufs[n] = (arr, ctypes.addressof(arr),
                         struct.Struct(f"{n}q").pack_into)
    buf[2](buf[0], 0, *[0 if a is None else a.data_ptr()
                        if torch.is_tensor(a) else int(a) for a in args])
    _launched(name, _fn(name)(buf[1], _stream(stream_of)))


def _launched(name: str, err: int, count: int = 1) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    cuda_build.LAUNCHES[name] += count


def _on_card(name: str, t: torch.Tensor, *others) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU ones (the
    plain version); raises on mixed or other devices."""
    dev = t.device
    for o in others:
        if o is not None and o.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"{dev} and {o.device}")
    if t.is_cuda:
        return True
    if dev.type != "cpu":
        raise RuntimeError(f"{name}: no kernel for {dev}")
    return False


def _points(name: str, xyz: torch.Tensor, mask) -> torch.Tensor:
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"{name}: xyz must be (B, N, 3) float32")
    if xyz.shape[1] == 0 or xyz.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: needs 1 <= N < 2**31 points")
    if mask is not None and (mask.shape != xyz.shape[:2]
                             or mask.dtype != torch.bool):
        raise ValueError(f"{name}: mask must be (B, N) bool")
    return _valid(mask, xyz).contiguous()


def furthest_point_sample(xyz: torch.Tensor, num_samples: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """K14-FPS: (B, N, 3) float32 [x (B, N) mask] -> (B, S) int32."""
    m = _points("furthest_point_sample", xyz, mask)
    if not _on_card("furthest_point_sample", xyz, m):
        return furthest_point_sample_ref(xyz, num_samples, mask)
    n = xyz.shape[1]
    return fps_launch(xyz, num_samples, m, 1 if n <= FPS_BLOCK_MAX
                      else fps_cluster(xyz.shape[0]))


_FPS_CLUSTERS = {}


def fps_cluster(b: int) -> int:
    """The blocks of K14-FPS's cluster for ``b`` samples on the card: 16
    when the card keeps ``b`` clusters of 16 resident at once, else 8
    (the kernel's ``fps_cluster`` query, cached by ``b``)."""
    c = _FPS_CLUSTERS.get(b)
    if c is None:
        c = _FPS_CLUSTERS[b] = _fn("fps_cluster")(b)
    return c


def fps_launch(xyz: torch.Tensor, num_samples: int, mask: torch.Tensor,
               cluster: int) -> torch.Tensor:
    """One K14-FPS launch on CUDA tensors (xyz (B, N, 3) float32, mask (B,
    N) bool) by a chosen route: ``cluster`` 1 (one block a sample, N <=
    4,096), 8 or 16 (a cluster of that many blocks; past FPS_CLUSTER_POINTS
    x cluster points the blocks stream the rest, their running distances
    in a (B, N) float32 scratch allocated here). ``furthest_point_sample``
    takes the route by N and batch; the others are for measuring the
    design (``chip_smoke.py``)."""
    b, n, _ = xyz.shape
    s = int(num_samples)
    out = torch.empty((b, s), dtype=torch.int32, device=xyz.device)
    if b == 0 or s == 0:
        return out
    xyz = xyz.detach().contiguous()
    tail = None
    if cluster != 1 and n > FPS_CLUSTER_POINTS * int(cluster):
        tail = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    err = _fn("furthest_point_sample")(
        xyz.data_ptr(), mask.contiguous().data_ptr(), b, n, s,
        out.data_ptr(), int(cluster), None if tail is None
        else tail.data_ptr(), _stream(xyz))
    _launched("furthest_point_sample", err)
    return out


def ball_query(radius: float, num_samples: int, xyz: torch.Tensor,
               query_xyz: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14-ball: -> (B, S, K) int32 idx, (B, S, K) bool valid."""
    m = _points("ball_query", xyz, mask)
    if query_xyz.dim() != 3 or query_xyz.shape[0] != xyz.shape[0] or \
            query_xyz.shape[-1] != 3 or query_xyz.dtype != torch.float32:
        raise ValueError("ball_query: query_xyz must be (B, S, 3) float32")
    if not _on_card("ball_query", xyz, query_xyz, m):
        return ball_query_ref(radius, num_samples, xyz, query_xyz, mask)
    grid = xyz.shape[1] > BALL_SCAN_MAX_POINTS and \
        ball_grid_params(radius) is not None
    return ball_query_launch(radius, num_samples, xyz, query_xyz, m,
                             grid=grid)


@functools.lru_cache(maxsize=64)
def _ball_scratch_words(b: int, n: int, bits: int) -> int:
    """int32 words of K14-ball's grid scratch (the kernel's query)."""
    return _fn("ball_query_scratch")(b, n, bits)


def ball_query_launch(radius: float, num_samples: int, xyz: torch.Tensor,
                      query_xyz: torch.Tensor, mask: torch.Tensor,
                      grid: bool, table_bits: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K14-ball call on CUDA tensors (mask (B, N) bool) by a chosen
    route: ``grid`` False scans every point in index order, True builds
    the cell grid in a hash table of 2^``table_bits`` buckets a sample
    (default ``ball_grid_table_bits(N)``; a small table forces collisions)
    and reads each query's cells. ``ball_query`` takes the route by N and
    the radius; the other routes are for tests and measuring."""
    b, n, _ = xyz.shape
    s, k = query_xyz.shape[1], int(num_samples)
    idx = torch.empty((b, s, k), dtype=torch.int32, device=xyz.device)
    valid = torch.empty((b, s, k), dtype=torch.bool, device=xyz.device)
    if b * s == 0 or k == 0:
        return idx, valid
    xyz, q = xyz.detach().contiguous(), query_xyz.detach().contiguous()
    inv = reach = 0.0
    bits, scratch = 0, None
    if grid:
        params = ball_grid_params(radius)
        if params is None:
            raise ValueError(f"ball_query: no grid route for radius "
                             f"{radius}")
        inv, reach = params
        bits = ball_grid_table_bits(n) if table_bits is None \
            else int(table_bits)
        scratch = torch.empty(_ball_scratch_words(b, n, bits),
                              dtype=torch.int32, device=xyz.device)
    err = _fn("ball_query")(
        xyz.data_ptr(), q.data_ptr(), mask.contiguous().data_ptr(), b, n, s,
        k, ctypes.c_float(_radius2(radius)), int(grid), ctypes.c_float(inv),
        ctypes.c_float(reach), bits,
        None if scratch is None else scratch.data_ptr(), idx.data_ptr(),
        valid.data_ptr(), _stream(xyz))
    _launched("ball_query", err)
    return idx, valid


def knn(k: int, xyz: torch.Tensor, query_xyz: torch.Tensor,
        mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14-NN: -> (B, S, k) int32 idx, (B, S, k) squared distances."""
    m = _points("knn", xyz, mask)
    if query_xyz.dim() != 3 or query_xyz.shape[0] != xyz.shape[0] or \
            query_xyz.shape[-1] != 3 or query_xyz.dtype != torch.float32:
        raise ValueError("knn: query_xyz must be (B, S, 3) float32")
    k = int(k)
    if not 1 <= k <= xyz.shape[1]:
        raise ValueError(f"knn: k = {k} is not in [1, N = {xyz.shape[1]}]")
    if torch.is_grad_enabled() and (xyz.requires_grad or
                                    query_xyz.requires_grad):
        raise RuntimeError("knn: no gradient through the distances (every "
                           "ported path feeds coordinates as data)")
    if not _on_card("knn", xyz, query_xyz, m):
        return knn_ref(k, xyz, query_xyz, mask)
    b, n, _ = xyz.shape
    s = query_xyz.shape[1]
    idx = torch.empty((b, s, k), dtype=torch.int32, device=xyz.device)
    d2 = torch.empty((b, s, k), dtype=torch.float32, device=xyz.device)
    if b * s == 0:
        return idx, d2
    xyz, q = xyz.contiguous(), query_xyz.contiguous()
    err = _fn("three_nn")(xyz.data_ptr(), q.data_ptr(), m.data_ptr(), b, n,
                          s, k, idx.data_ptr(), d2.data_ptr(), _stream(xyz))
    _launched("three_nn", err)
    return idx, d2


def three_nn(query_xyz: torch.Tensor, xyz: torch.Tensor,
             mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest source points per query -> (B, S, 3) distances, (B, S, 3)
    int32 idx."""
    idx, d2 = knn(3, xyz, query_xyz, mask)
    return torch.sqrt(d2.clamp_min(1e-10)), idx


# ---------------------------------------------------- K14-gather (op ids)
_FORWARD, _BACKWARD, _WEIGHT_GRAD = 0, 1, 2


_PACK = struct.Struct("12q").pack_into


def _gather_call(op: int, a, b, idx, w, scratch, out, rows: int, j: int,
                 n: int, c: int, r: int) -> None:
    """One call of ``point_gather``: its twelve arguments packed into a
    buffer of this thread (one ctypes argument converts faster than
    twelve)."""
    args = getattr(_ARGS, "buf", None)
    if args is None:
        buf = (ctypes.c_longlong * 12)()
        args = _ARGS.buf = (buf, ctypes.addressof(buf))
    _PACK(args[0], 0, op, 0 if a is None else a.data_ptr(),
          0 if b is None else b.data_ptr(), idx.data_ptr(),
          0 if w is None else w.data_ptr(),
          0 if scratch is None else scratch.data_ptr(), out.data_ptr(),
          rows, j, n, c, r)
    _launched("point_gather", _fn("point_gather")(args[1], _stream(out)))


def _list_scratch(segs: int, slots: int, device) -> torch.Tensor:
    words = _fn("point_gather_scratch")(segs, slots)
    return torch.empty(words, dtype=torch.int32, device=device)


def slot_lists(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """CSR of the slots that read each source row: (B, R) int32 indices
    into (B, n) rows -> ptr (B * n + 1) int32 offsets and the slot ids
    (flattened over B * R) grouped by row, each row's in increasing order
    (the backward's sums run in slot order and repeat): the plain
    version, a stable sort, of the list that K14-gather's backward builds
    in its own call on the card (``csrc/point_gather.cu``, op 1, counted
    as ``LAUNCHES["point_gather_layout"]``)."""
    b, r = idx.shape
    keys = (idx.long() + n * torch.arange(b, device=idx.device)[:, None]
            ).reshape(-1)
    order = torch.argsort(keys, stable=True)
    ptr = torch.searchsorted(keys[order], torch.arange(
        b * n + 1, device=idx.device))
    return ptr.to(torch.int32), order.to(torch.int32)


def _gather(feats, idx, weight, j: int, rows: int, shape) -> torch.Tensor:
    """K14-gather's forward on the card: (B, N, C) contiguous rows at
    contiguous int32 slots, ``rows`` x ``j`` a sample [x weights of the
    slots' shape] -> ``shape``, (B, rows, C) in memory."""
    b, n, c = feats.shape
    out = feats.new_empty(shape)
    if b and rows and c:
        _gather_call(_FORWARD, feats, None, idx, weight, None, out,
                     b * rows, j, n, c, rows)
    return out


class _PointGather(torch.autograd.Function):
    """K14-gather with a gradient (``_gather``'s arguments). Backward: the
    features' gradient summed over each source row's slots in slot order
    (over ``slot_lists``' list, built in the same call), the weights' the
    dot of the output gradient with each slot's row."""

    @staticmethod
    def forward(ctx, feats, idx, weight, j, rows, shape):
        ctx.j, ctx.rows = j, rows
        ctx.save_for_backward(feats if weight is not None else None, idx,
                              weight)
        ctx.feats_shape = tuple(feats.shape)
        return _gather(feats, idx, weight, j, rows, shape)

    @staticmethod
    def backward(ctx, g):
        feats, idx, weight = ctx.saved_tensors
        b, n, c = ctx.feats_shape
        j, rows = ctx.j, ctx.rows
        g = g.contiguous()
        gf = gw = None
        if ctx.needs_input_grad[0]:
            if not g.numel():                 # no rows read: zero
                gf = g.new_zeros((b, n, c))
            else:
                gf = g.new_empty((b, n, c))
                _gather_call(_BACKWARD, g, None, idx, weight, _list_scratch(
                    b * n, b * rows * j, g.device), gf, b * rows, j, n, c,
                    rows)
                cuda_build.LAUNCHES["point_gather_layout"] += 1
        if weight is not None and ctx.needs_input_grad[2]:
            if not g.numel():
                gw = g.new_zeros(weight.shape)
            else:
                gw = g.new_empty(weight.shape)
                _gather_call(_WEIGHT_GRAD, g, feats, idx, None, None, gw,
                             b * rows, j, n, c, rows)
        return gf, None, gw, None, None, None


def _gather_args(name: str, feats: torch.Tensor, idx: torch.Tensor) -> None:
    if feats.dim() != 3 or feats.dtype != torch.float32:
        raise TypeError(f"{name}: feats must be (B, N, C) float32")
    if idx.dtype != torch.int32 or idx.shape[0] != feats.shape[0]:
        raise TypeError(f"{name}: idx must be int32 with feats' batch size")
    if feats.shape[1] == 0:
        raise ValueError(f"{name}: no source rows")


def _point_gather(feats, idx, weight, j: int, rows: int, shape
                  ) -> torch.Tensor:
    """The card's call: ``rows`` rows of ``j`` slots a sample into
    ``shape``; without autograd when no input needs a gradient (the serve
    path runs under ``no_grad``)."""
    if not feats.is_contiguous():
        feats = feats.contiguous()
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if weight is not None:
        if not weight.is_contiguous():
            weight = weight.contiguous()
        if weight.requires_grad and torch.is_grad_enabled():
            return _PointGather.apply(feats, idx, weight, j, rows, shape)
    if feats.requires_grad and torch.is_grad_enabled():
        return _PointGather.apply(feats, idx, weight, j, rows, shape)
    return _gather(feats, idx, weight, j, rows, shape)


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K14-gather: (B, N, C) x (B, S) int32 -> (B, S, C)."""
    _gather_args("gather_points", feats, idx)
    if not _on_card("gather_points", feats, idx):
        return gather_points_ref(feats, idx)
    b, s = idx.shape
    return _point_gather(feats, idx, None, 1, s, (b, s, feats.shape[2]))


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K14-gather: (B, N, C) x (B, S, K) int32 -> (B, S, K, C)."""
    _gather_args("group_points", feats, idx)
    if not _on_card("group_points", feats, idx):
        return group_points_ref(feats, idx)
    b, s, k = idx.shape
    return _point_gather(feats, idx, None, 1, s * k,
                         (b, s, k, feats.shape[2]))


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """K14-gather: (B, M, C) x (B, S, J) int32 x (B, S, J) float32 ->
    (B, S, C)."""
    _gather_args("three_interpolate", feats, idx)
    if weight.shape != idx.shape or weight.dtype != torch.float32:
        raise TypeError("three_interpolate: weight must be float32 of "
                        "idx's shape")
    if not _on_card("three_interpolate", feats, idx, weight):
        return three_interpolate_ref(feats, idx, weight)
    b, s, j = idx.shape
    return _point_gather(feats, idx, weight, j, s, (b, s, feats.shape[2]))
