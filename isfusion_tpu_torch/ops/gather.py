"""Masked row gather — K12, the port of the repository's Pallas kernel.

``masked_gather(src, idx, fmask)[i] = src[idx[i]] if fmask[i] else 0``.

Replaces ``tools/analysis_tools/micro_dma_gather.py:make_dma_gather``
(its ``pallas_call`` at :97), the TPU run-descriptor DMA gather written for
the sparse encoder's neighbour-row gathers
(``isfusion_tpu/ops/sparse_cols.py:_gather_rows``). The port's sparse
conv (``ops/sparse_conv.py``) forms every im2col through it.

Bound on an H100: bytes moved / 3.35 TB/s, with bytes = each distinct
kept source row read once + every output row written once + the index and
mask read once (the output dominates: an im2col is 27x its input). The CUDA
kernel (``csrc/masked_gather.cu``) walks the output as 16-byte vectors so
that neighbouring threads touch neighbouring addresses: consecutive output
rows that read consecutive source rows — the near-monotone neighbour slots
of a sorted site table — become coalesced reads, the GPU form of the TPU
kernel's run-sized DMAs. Masked rows read nothing.

On a CPU tensor the wrapper takes the plain version; on a CUDA tensor it
launches the kernel or raises. There is no backward (the Pallas kernel has
none); the predict path runs under ``torch.no_grad``.
"""
from __future__ import annotations

import torch

from . import cuda_build

_ROW_ALIGN = {torch.bfloat16: 8, torch.float32: 4}


def masked_gather_ref(src: torch.Tensor, idx: torch.Tensor,
                      fmask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the CPU path and the kernel's yardstick)."""
    v = src.shape[0]
    rows = src[idx.long().clamp(0, v - 1)]
    return torch.where(fmask[:, None], rows, torch.zeros((), dtype=src.dtype,
                                                         device=src.device))


def _check(src: torch.Tensor, idx: torch.Tensor, fmask: torch.Tensor):
    if src.dim() != 2 or idx.dim() != 1 or fmask.dim() != 1:
        raise ValueError("masked_gather: src (V, F), idx (N,), fmask (N,)")
    if idx.shape[0] != fmask.shape[0]:
        raise ValueError("masked_gather: idx and fmask lengths differ")
    if src.dtype not in _ROW_ALIGN:
        raise TypeError(f"masked_gather: src dtype {src.dtype} is not "
                        "bfloat16 or float32")
    if src.shape[1] % _ROW_ALIGN[src.dtype]:
        raise ValueError(
            f"masked_gather: row width {src.shape[1]} is not a multiple of "
            f"{_ROW_ALIGN[src.dtype]} {src.dtype} values (16 bytes)")
    if idx.dtype != torch.int32 or fmask.dtype != torch.bool:
        raise TypeError("masked_gather: idx must be int32, fmask bool")
    if src.shape[0] == 0 or src.shape[0] >= 2 ** 31:
        raise ValueError("masked_gather: src needs 1 <= V < 2**31 rows")
    if not (src.device == idx.device == fmask.device):
        raise ValueError("masked_gather: tensors on different devices")
    if not (src.is_contiguous() and idx.is_contiguous()
            and fmask.is_contiguous()):
        raise ValueError("masked_gather: tensors must be contiguous")


def masked_gather(src: torch.Tensor, idx: torch.Tensor,
                  fmask: torch.Tensor) -> torch.Tensor:
    """(V, F) rows gathered at ``idx`` where ``fmask``, zeros elsewhere."""
    _check(src, idx, fmask)
    if src.device.type == "cpu":
        return masked_gather_ref(src, idx, fmask)
    if src.device.type != "cuda":
        raise RuntimeError(f"masked_gather: no kernel for {src.device}")
    n, f = idx.shape[0], src.shape[1]
    out = torch.empty((n, f), dtype=src.dtype, device=src.device)
    if n == 0:
        return out
    lib = cuda_build.load("masked_gather")
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.masked_gather(src.data_ptr(), idx.data_ptr(),
                            fmask.data_ptr(), out.data_ptr(), n,
                            src.shape[0], f * src.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"masked_gather: kernel launch failed with CUDA "
                           f"error {err}")
    cuda_build.LAUNCHES["masked_gather"] += 1
    return out
