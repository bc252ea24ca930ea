"""Sparse 3D convolution over an active-site rulebook (spconv semantics).

Counterpart of the JAX package's sparse engines (``ops/sparse.py``,
``ops/sparse_cols.py``, ``ops/sparse_dense.py``): the same function, none
of their TPU layout machinery (BEV columns, x-dilation, u-factorisation,
host plans, capacity caps).

- Active sites are a table of (b, z, y, x) coordinates sorted by their
  batch-major int64 linear key; lookups are ``searchsorted`` on it.
- ``subm_rulebook``: a submanifold conv keeps the active set; tap k of
  site o reads input o + k - k//2.
- ``strided_rulebook``: output site o is active iff some active input lies
  in its receptive field, input = o * s - p + k.
- ``sparse_conv``: output-stationary gather-GEMM. The (N_out, K * Cin)
  im2col is formed by the masked-gather kernel (``ops/gather.py``, K12)
  with ``fmask`` = neighbour found, then one matmul with the
  (K * Cin, Cout) weight. No atomics: deterministic.

The rulebook construction is plain PyTorch for now (ROADMAP queue K3: implicit
GEMM over the rulebook as one hand-written kernel).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence, Tuple

import torch

from .gather import masked_gather

# im2col elements per chunk: bounds the transient (rows, K * Cin) buffer
IM2COL_CHUNK = 1 << 27


class SparseTensor(NamedTuple):
    feats: torch.Tensor        # (N, C)
    coords: torch.Tensor       # (N, 4) int32 (b, z, y, x), sorted by key
    keys: torch.Tensor         # (N,) int64 ascending
    shape: Tuple[int, int, int]  # (nz, ny, nx)
    batch_size: int


def linear_keys(coords: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    nz, ny, nx = (int(s) for s in shape)
    c = coords.long()
    return ((c[..., 0] * nz + c[..., 1]) * ny + c[..., 2]) * nx + c[..., 3]


def build_sparse(feats: torch.Tensor, coords: torch.Tensor,
                 shape: Sequence[int], batch_size: int) -> SparseTensor:
    """Sort unique (b, z, y, x) sites by key (the table's invariant)."""
    keys = linear_keys(coords, shape)
    keys, order = torch.sort(keys)
    return SparseTensor(feats[order], coords[order].to(torch.int32), keys,
                        tuple(int(s) for s in shape), int(batch_size))


def _offsets(ksize: Sequence[int], device) -> torch.Tensor:
    return torch.tensor(list(itertools.product(*[range(int(k))
                                                 for k in ksize])),
                        dtype=torch.int64, device=device)


def _lookup(sp: SparseTensor, q: torch.Tensor, valid: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, 4) query coords -> (row int32, found bool) in the site table."""
    qk = torch.where(valid, linear_keys(q, sp.shape),
                     torch.full_like(valid, -1, dtype=torch.int64))
    if sp.keys.numel() == 0:
        z = torch.zeros(qk.shape, dtype=torch.int32, device=qk.device)
        return z, torch.zeros_like(valid)
    pos = torch.searchsorted(sp.keys, qk).clamp_max(sp.keys.numel() - 1)
    found = valid & (sp.keys[pos] == qk)
    return pos.to(torch.int32), found


def _in_bounds(c: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    hi = torch.tensor(list(shape), dtype=c.dtype, device=c.device)
    return ((c[..., 1:] >= 0) & (c[..., 1:] < hi)).all(-1)


def subm_rulebook(sp: SparseTensor, ksize=(3, 3, 3)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) neighbour rows + found mask of a submanifold conv."""
    off = _offsets(ksize, sp.coords.device) - \
        torch.tensor([k // 2 for k in ksize], device=sp.coords.device)
    q = sp.coords.long()[:, None, :].clone().repeat(1, off.shape[0], 1)
    q[..., 1:] += off[None]
    return _lookup(sp, q, _in_bounds(q, sp.shape))


def _norm3(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def strided_rulebook(sp: SparseTensor, ksize, stride, padding
                     ) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor]:
    """Output site table (empty feats) and its (N_out, K) input rows +
    found mask for a regular (strided) sparse conv."""
    ks, s, p = _norm3(ksize), _norm3(stride), _norm3(padding)
    out_shape = tuple((sp.shape[d] + 2 * p[d] - ks[d]) // s[d] + 1
                      for d in range(3))
    dev = sp.coords.device
    off = _offsets(ks, dev)                                   # (K, 3)
    sv = torch.tensor(s, device=dev)
    pv = torch.tensor(p, device=dev)
    hi = torch.tensor(out_shape, device=dev)
    # every output each active input reaches: o * s = c + p - k
    num = sp.coords.long()[:, None, 1:] + pv - off[None]      # (N, K, 3)
    o = torch.div(num, sv, rounding_mode="floor")
    ok = ((o * sv == num) & (o >= 0) & (o < hi)).all(-1)
    bcol = sp.coords.long()[:, None, :1].expand(-1, off.shape[0], 1)
    cand = torch.cat([bcol, o], -1)[ok]
    out_keys = torch.unique(linear_keys(cand, out_shape), sorted=True)
    nz, ny, nx = out_shape
    x = out_keys % nx
    r = out_keys // nx
    y = r % ny
    r = r // ny
    out_coords = torch.stack([r // nz, r % nz, y, x], -1)
    out = SparseTensor(torch.empty(0, device=dev), out_coords.to(torch.int32),
                       out_keys, out_shape, sp.batch_size)
    q = out_coords[:, None, :].repeat(1, off.shape[0], 1)
    q[..., 1:] = q[..., 1:] * sv - pv + off[None]
    rows, found = _lookup(sp, q, _in_bounds(q, sp.shape))
    return out, rows, found


def flat_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """spconv2 layout (Cout, kz, ky, kx, Cin) -> (K * Cin, Cout)."""
    return weight.permute(1, 2, 3, 4, 0).reshape(-1, weight.shape[0]).to(
        dtype)


def sparse_conv(feats: torch.Tensor, rows: torch.Tensor, found: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Gather-GEMM: (N_in, Cin) feats, (N_out, K) rulebook -> (N_out, Cout)
    in the feats' dtype. The im2col goes through the masked-gather kernel in
    row chunks of at most ``IM2COL_CHUNK`` elements."""
    n_out, k = rows.shape
    cin = feats.shape[1]
    w = flat_weight(weight, feats.dtype)
    out = torch.empty((n_out, w.shape[1]), dtype=feats.dtype,
                      device=feats.device)
    if n_out == 0 or feats.shape[0] == 0:
        return out.zero_()
    src = feats.contiguous()
    step = max(1, IM2COL_CHUNK // (k * cin))
    for a in range(0, n_out, step):
        r = rows[a:a + step].reshape(-1).contiguous()
        f = found[a:a + step].reshape(-1).contiguous()
        cols = masked_gather(src, r, f).view(-1, k * cin)
        torch.matmul(cols, w, out=out[a:a + step])
    return out
