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
- ``inverse_rulebook``: a sparse inverse conv (SparseUNet's upsampling)
  writes onto a saved site table; tap k of target site h reads the low
  site l with l * s - p + k = h. The JAX package's strided conv caps its
  output sites (``out_cap``, a TPU table size); ``strided_rulebook``
  keeps them all.
- ``sparse_conv``: output-stationary gather-GEMM. The (N_out, K * Cin)
  im2col is formed by the masked-gather kernel (``ops/gather.py``, K12)
  with ``fmask`` = neighbour found, then one matmul with the
  (K * Cin, Cout) weight. No atomics: deterministic.
- Its backward is built from K12 too (``SparseConvFunction``). For a
  fixed tap k the map o -> rows[o, k] is injective over found pairs (subm:
  i = o + k - k//2; strided: i = o * s - p + k; inverse: o = i * s - p +
  k; ``rulebook_is_injective`` checks it), so the transposed
  rulebook ``rows_T[rows[o, k], k] = o`` is written by one collision-free
  ``index_put_``. dX is the gather-GEMM of dY over it with the per-tap
  transposed weights; dW is im2col^T @ dY with the im2col regathered chunk
  by chunk (only inputs and rulebooks are saved), summed in float32 and
  cast to the weight's dtype once. No atomics anywhere.

The rulebook construction is plain PyTorch for now (ROADMAP queue K3: implicit
GEMM over the rulebook as one hand-written kernel).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from .gather import masked_gather, masked_gather_ref

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


def inverse_rulebook(low: SparseTensor, target: SparseTensor, ksize,
                     stride, padding) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N_target, K) rows of ``low`` + found mask of a sparse inverse conv
    onto ``target``'s saved sites: tap k of target site h reads the low
    site l with l * s - p + k == h (exact division, l inside ``low``'s
    grid, the same sample), the transpose of ``strided_rulebook``."""
    ks, s, p = _norm3(ksize), _norm3(stride), _norm3(padding)
    dev = target.coords.device
    off = _offsets(ks, dev)                                   # (K, 3)
    sv = torch.tensor(s, device=dev)
    num = target.coords.long()[:, None, 1:] + torch.tensor(p, device=dev) \
        - off[None]                                           # (N, K, 3)
    l_zyx = torch.div(num, sv, rounding_mode="floor")
    exact = (l_zyx * sv == num).all(-1)
    q = torch.cat([target.coords.long()[:, None, :1].expand(
        -1, off.shape[0], 1), l_zyx], -1)
    return _lookup(low, q, exact & _in_bounds(q, low.shape))


def rulebook_is_injective(rows: torch.Tensor, found: torch.Tensor) -> bool:
    """Whether, for each tap k, no two found pairs of a rulebook read the
    same row: what ``transpose_rulebook`` (the backward) assumes."""
    k = rows.shape[1]
    keys = (rows.long() * k + torch.arange(k, device=rows.device))[found]
    return bool(torch.unique(keys).numel() == keys.numel())


def flat_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """spconv2 layout (Cout, kz, ky, kx, Cin) -> (K * Cin, Cout)."""
    return weight.permute(1, 2, 3, 4, 0).reshape(-1, weight.shape[0]).to(
        dtype)


def transpose_rulebook(rows: torch.Tensor, found: torch.Tensor, n_in: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N_out, K) rulebook -> (N_in, K) ``rows_T`` (int32) + ``found_T``
    with ``rows_T[rows[o, k], k] = o`` for every found pair. Pairs that are
    not found are written to one trash slot past the end, which is then
    cut off, so the kept entries see exactly one write each."""
    n_out, k = rows.shape
    dev = rows.device
    taps = torch.arange(k, device=dev)
    dest = torch.where(found, rows.long() * k + taps,
                       torch.full((), n_in * k, dtype=torch.long, device=dev))
    src_rows = torch.arange(n_out, dtype=torch.int32, device=dev)[:, None]
    rows_t = torch.zeros(n_in * k + 1, dtype=torch.int32, device=dev)
    rows_t.index_put_((dest.reshape(-1),),
                      src_rows.expand(n_out, k).reshape(-1))
    found_t = torch.zeros(n_in * k + 1, dtype=torch.bool, device=dev)
    found_t.index_put_((dest.reshape(-1),), found.reshape(-1))
    return rows_t[:-1].view(n_in, k), found_t[:-1].view(n_in, k)


def _gather_gemm(src: torch.Tensor, rows: torch.Tensor, found: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """sum_k found[o, k] * src[rows[o, k]] @ w_k, im2col by K12 in row
    chunks of at most ``IM2COL_CHUNK`` elements; ``w`` (K * C, Cout)."""
    n_out, k = rows.shape
    c = src.shape[1]
    out = torch.empty((n_out, w.shape[1]), dtype=src.dtype, device=src.device)
    if n_out == 0 or src.shape[0] == 0:
        return out.zero_()
    step = max(1, IM2COL_CHUNK // (k * c))
    for a in range(0, n_out, step):
        r = rows[a:a + step].reshape(-1).contiguous()
        f = found[a:a + step].reshape(-1).contiguous()
        cols = masked_gather(src, r, f).view(-1, k * c)
        torch.matmul(cols, w, out=out[a:a + step])
    return out


class SparseConvFunction(torch.autograd.Function):
    """Gather-GEMM sparse conv whose forward and backward are built from
    the K12 masked gather (see the module docstring). Saves only the
    input features, the weight and the rulebook."""

    @staticmethod
    def forward(ctx, feats, rows, found, weight):
        src = feats.contiguous()
        ctx.save_for_backward(src, rows, found, weight)
        return _gather_gemm(src, rows, found, flat_weight(weight,
                                                          feats.dtype))

    @staticmethod
    def backward(ctx, dy):
        src, rows, found, weight = ctx.saved_tensors
        n_in, cin = src.shape
        n_out, k = rows.shape
        cout = weight.shape[0]
        dy = dy.contiguous().to(src.dtype)
        w = flat_weight(weight, src.dtype)                 # (K * Cin, Cout)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            rows_t, found_t = transpose_rulebook(rows, found, n_in)
            w_t = w.view(k, cin, cout).transpose(1, 2).reshape(k * cout, cin)
            dx = _gather_gemm(dy, rows_t, found_t, w_t)
        if ctx.needs_input_grad[3]:
            acc = torch.zeros((k * cin, cout), dtype=torch.float32,
                              device=src.device)
            if n_out and n_in:
                step = max(1, IM2COL_CHUNK // (k * cin))
                for a in range(0, n_out, step):
                    r = rows[a:a + step].reshape(-1).contiguous()
                    f = found[a:a + step].reshape(-1).contiguous()
                    cols = masked_gather(src, r, f).view(-1, k * cin)
                    acc += torch.matmul(cols.t(), dy[a:a + step]).float()
            # (K * Cin, Cout) -> spconv2 (Cout, kz, ky, kx, Cin)
            dw = acc.view(*weight.shape[1:4], cin, cout).permute(
                4, 0, 1, 2, 3).to(weight.dtype)
        return dx, None, None, dw


def sparse_conv_plain(feats: torch.Tensor, rows: torch.Tensor,
                      found: torch.Tensor, weight: torch.Tensor
                      ) -> torch.Tensor:
    """The plain version: autograd through the gather's plain version and
    ``torch.matmul`` (the CPU route and the Function's yardstick)."""
    n_out, k = rows.shape
    w = flat_weight(weight, feats.dtype)
    if n_out == 0 or feats.shape[0] == 0:
        return torch.zeros((n_out, w.shape[1]), dtype=feats.dtype,
                           device=feats.device)
    cols = masked_gather_ref(feats, rows.reshape(-1), found.reshape(-1))
    return torch.matmul(cols.view(n_out, -1), w)


def sparse_conv(feats: torch.Tensor, rows: torch.Tensor, found: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Gather-GEMM: (N_in, Cin) feats, (N_out, K) rulebook, spconv2 weight
    (Cout, kz, ky, kx, Cin) -> (N_out, Cout) in the feats' dtype. On a CUDA
    tensor it runs ``SparseConvFunction`` (K12 forward and backward); on a
    CPU tensor the plain version."""
    if feats.device.type == "cpu":
        return sparse_conv_plain(feats, rows, found, weight)
    # K12 moves 16-byte row vectors: the forward gathers Cin-wide rows, the
    # backward Cout-wide ones. Other widths (CenterPoint's 5 point
    # features) are padded with zero channels, which add exact zeros
    align = 16 // feats.element_size()
    cout = weight.shape[0]
    pin, pout = -feats.shape[1] % align, -cout % align
    if pin:
        feats, weight = F.pad(feats, (0, pin)), F.pad(weight, (0, pin))
    if pout:
        weight = F.pad(weight, (0, 0) * 4 + (0, pout))
    out = SparseConvFunction.apply(feats, rows, found, weight)
    return out[:, :cout] if pout else out
