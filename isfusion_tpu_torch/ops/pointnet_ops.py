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
(K14-ball), ``csrc/three_nn.cu`` (K14-NN; k <= 16) and
``csrc/point_gather.cu`` (K14-gather: the three gathers forward, their
backward by a CSR of each source row's slots, and the weights' gradient).
The plain versions bound their (S, N) matrices by working on
``QUERY_CHUNK`` queries at a time, with equal results. The index ops have
no gradient; ``knn`` raises when asked for one (its distances are
computed from coordinates that every ported path feeds as data).
``interpolation_weights`` is plain PyTorch on every device (elementwise
over (S, 3)).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_build

_BIG = 1e10
# queries a plain version handles at once: its (chunk, N) matrices stay
# near 100 MB at the first SA level's 40,000 points
QUERY_CHUNK = 256
# the largest k of the K14-NN kernel (no ported model asks for more)
KNN_MAX_K = 16
# the most points of a K14-FPS sample (its running distances live in
# shared memory; no ported path has more than 40,000)
FPS_MAX_POINTS = 50_000


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
def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name: str, err: int, count: int = 1) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    cuda_build.LAUNCHES[name] += count


def _on_card(name: str, *tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU ones (the
    plain version); raises on mixed or other devices."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {dev}")
    return True


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
    b, n, _ = xyz.shape
    if n > FPS_MAX_POINTS:
        raise ValueError(f"furthest_point_sample: the kernel takes N <= "
                         f"{FPS_MAX_POINTS} points, not {n}")
    s = int(num_samples)
    out = torch.empty((b, s), dtype=torch.int32, device=xyz.device)
    if b == 0 or s == 0:
        return out
    xyz = xyz.detach().contiguous()
    lib = cuda_build.load("furthest_point_sample")
    err = lib.furthest_point_sample(xyz.data_ptr(), m.data_ptr(), b, n, s,
                                    out.data_ptr(), _stream(xyz))
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
    b, n, _ = xyz.shape
    s, k = query_xyz.shape[1], int(num_samples)
    idx = torch.empty((b, s, k), dtype=torch.int32, device=xyz.device)
    valid = torch.empty((b, s, k), dtype=torch.bool, device=xyz.device)
    if b * s == 0 or k == 0:
        return idx, valid
    xyz, q = xyz.detach().contiguous(), query_xyz.detach().contiguous()
    lib = cuda_build.load("ball_query")
    err = lib.ball_query(xyz.data_ptr(), q.data_ptr(), m.data_ptr(), b, n,
                         s, k, ctypes.c_float(_radius2(radius)),
                         idx.data_ptr(), valid.data_ptr(), _stream(xyz))
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
    if k > KNN_MAX_K:
        raise ValueError(f"knn: the kernel takes k <= {KNN_MAX_K}, not {k}")
    b, n, _ = xyz.shape
    s = query_xyz.shape[1]
    idx = torch.empty((b, s, k), dtype=torch.int32, device=xyz.device)
    d2 = torch.empty((b, s, k), dtype=torch.float32, device=xyz.device)
    if b * s == 0:
        return idx, d2
    xyz, q = xyz.contiguous(), query_xyz.contiguous()
    lib = cuda_build.load("three_nn")
    err = lib.three_nn(xyz.data_ptr(), q.data_ptr(), m.data_ptr(), b, n, s,
                       k, idx.data_ptr(), d2.data_ptr(), _stream(xyz))
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


def _gather_call(op: int, a, b, idx, w, ptr, out, rows: int, j: int, n: int,
                 c: int, r: int) -> None:
    lib = cuda_build.load("point_gather")
    p = [0 if t is None else t.data_ptr() for t in (a, b, idx, w, ptr)]
    err = lib.point_gather(op, *p, out.data_ptr(), rows, j, n, c, r,
                           _stream(out))
    _launched("point_gather", err)


def slot_lists(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """CSR of the slots that read each source row: (B, R) int32 indices
    into (B, n) rows -> ptr (B * n + 1) int32 offsets and the slot ids
    (flattened over B * R) grouped by row, each row's in increasing order
    (a stable sort: the backward's sums run in slot order and repeat)."""
    b, r = idx.shape
    keys = (idx.long() + n * torch.arange(b, device=idx.device)[:, None]
            ).reshape(-1)
    order = torch.argsort(keys, stable=True)
    ptr = torch.searchsorted(keys[order], torch.arange(
        b * n + 1, device=idx.device))
    return ptr.to(torch.int32), order.to(torch.int32)


class _PointGather(torch.autograd.Function):
    """K14-gather over flattened slots: feats (B, N, C), idx (B, R * J)
    int32, weight (B, R * J) float32 or None -> (B, R, C), each row the
    sum of its J slots' weighted source rows (J = 1 without weights: a
    copy). Backward: the features' gradient summed over each source row's
    slots in slot order (``slot_lists``), the weights' the dot of the
    output gradient with each slot's row."""

    @staticmethod
    def forward(ctx, feats, idx, weight, j):
        b, n, c = feats.shape
        rows = idx.shape[1] // j
        out = torch.empty((b, rows, c), dtype=feats.dtype,
                          device=feats.device)
        if out.numel():
            _gather_call(_FORWARD, feats, None, idx, weight, None, out,
                         b * rows, j, n, c, rows)
        ctx.j = j
        ctx.save_for_backward(feats if weight is not None else None, idx,
                              weight)
        ctx.feats_shape = (b, n, c)
        return out

    @staticmethod
    def backward(ctx, g):
        feats, idx, weight = ctx.saved_tensors
        b, n, c = ctx.feats_shape
        j = ctx.j
        rows = idx.shape[1] // j
        g = g.contiguous()
        gf = gw = None
        if ctx.needs_input_grad[0]:
            gf = torch.empty((b, n, c), dtype=g.dtype, device=g.device)
            ptr, slots = slot_lists(idx, n)
            _gather_call(_BACKWARD, g, None, slots, weight, ptr, gf, b * n,
                         j, n, c, rows)
        if weight is not None and ctx.needs_input_grad[2]:
            gw = torch.empty(idx.shape, dtype=g.dtype, device=g.device)
            _gather_call(_WEIGHT_GRAD, g, feats, idx, None, None, gw,
                         b * rows, j, n, c, rows)
        return gf, None, gw, None


def _gather_args(name: str, feats: torch.Tensor, idx: torch.Tensor) -> None:
    if feats.dim() != 3 or feats.dtype != torch.float32:
        raise TypeError(f"{name}: feats must be (B, N, C) float32")
    if idx.dtype != torch.int32 or idx.shape[0] != feats.shape[0]:
        raise TypeError(f"{name}: idx must be int32 with feats' batch size")
    if feats.shape[1] == 0:
        raise ValueError(f"{name}: no source rows")


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K14-gather: (B, N, C) x (B, S) int32 -> (B, S, C)."""
    _gather_args("gather_points", feats, idx)
    if not _on_card("gather_points", feats, idx):
        return gather_points_ref(feats, idx)
    return _PointGather.apply(feats.contiguous(), idx.contiguous(), None, 1)


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K14-gather: (B, N, C) x (B, S, K) int32 -> (B, S, K, C)."""
    _gather_args("group_points", feats, idx)
    if not _on_card("group_points", feats, idx):
        return group_points_ref(feats, idx)
    b, s, k = idx.shape
    out = _PointGather.apply(feats.contiguous(), idx.reshape(b, s * k)
                             .contiguous(), None, 1)
    return out.reshape(b, s, k, feats.shape[-1])


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
    return _PointGather.apply(feats.contiguous(), idx.reshape(b, s * j)
                              .contiguous(), weight.reshape(b, s * j)
                              .contiguous(), j)
