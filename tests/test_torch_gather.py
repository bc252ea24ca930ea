"""K12 masked row gather: the port's plain version against the repository's
Pallas kernel (tools/analysis_tools/micro_dma_gather.py:make_dma_gather,
run on the CPU in interpret mode), and the wrapper's dispatch rules.

Tolerance: exact. A gather is a copy, so the port's plain version must
reproduce the Pallas kernel bit for bit on finite inputs (the Pallas kernel
multiplies by the mask, the port writes zeros: equal wherever src is finite).
"""
import functools
import os
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isfusion_tpu_torch.ops import cuda_build
from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools",
                                "analysis_tools"))
import micro_dma_gather  # noqa: E402

V, F, N, BLOCK, RUN = 64, 32, 64, 32, 8


def _indices(kind: str, rng: np.random.Generator):
    """(idx, fmask) over N rows: aligned runs of consecutive sources,
    ragged chunks, and masked rows."""
    if kind == "runs":            # every chunk of RUN is a clean run
        idx = (np.arange(N) + 5) % (V - RUN)
        fmask = np.ones(N, bool)
    elif kind == "runs_masked":   # near-monotone, ~8% masked
        steps = np.where(rng.uniform(size=N) < 0.1,
                         rng.integers(2, 9, N), 1)
        idx = np.cumsum(steps) % V
        fmask = rng.uniform(size=N) > 0.08
    else:                         # ragged: a random permutation
        idx = rng.permutation(N) % V
        fmask = rng.uniform(size=N) > 0.3
    return idx.astype(np.int32), fmask


@pytest.mark.parametrize("kind", ["runs", "runs_masked", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(monkeypatch, kind, dtype):
    monkeypatch.setattr(micro_dma_gather.pl, "pallas_call", functools.partial(
        micro_dma_gather.pl.pallas_call, interpret=True))
    rng = np.random.default_rng(zlib.crc32(f"{kind}/{dtype}".encode()))
    src = rng.normal(size=(V, F)).astype(np.float32)
    idx, fmask = _indices(kind, rng)
    jdt = jnp.dtype(dtype)
    gather = micro_dma_gather.make_dma_gather(V, F, N, jdt, block=BLOCK,
                                              run=RUN)
    want = np.asarray(gather(jnp.asarray(src, jdt), jnp.asarray(idx),
                             jnp.asarray(fmask[:, None], jnp.float32))
                      .astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = masked_gather_ref(torch.from_numpy(src).to(tdt),
                            torch.from_numpy(idx), torch.from_numpy(fmask))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_cpu_tensor_takes_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError("a CUDA kernel build was attempted for a CPU "
                             "tensor")

    monkeypatch.setattr(cuda_build, "build", no_build)
    monkeypatch.setattr(cuda_build, "load", no_build)
    before = dict(cuda_build.LAUNCHES)
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.normal(size=(V, F)).astype(np.float32))
    idx, fmask = _indices("runs_masked", rng)
    idx, fmask = torch.from_numpy(idx), torch.from_numpy(fmask)
    got = masked_gather(src, idx, fmask)
    assert torch.equal(got, masked_gather_ref(src, idx, fmask))
    assert torch.equal(got[~fmask], torch.zeros_like(got[~fmask]))
    assert cuda_build.LAUNCHES == before


@pytest.mark.parametrize("bad", ["width", "dtype", "index_dtype",
                                 "noncontiguous", "lengths"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    src = torch.zeros((V, F))
    idx = torch.zeros(N, dtype=torch.int32)
    fmask = torch.ones(N, dtype=torch.bool)
    if bad == "width":
        src = torch.zeros((V, 6))           # 24 bytes: not 16-byte rows
    elif bad == "dtype":
        src = torch.zeros((V, F), dtype=torch.float16)
    elif bad == "index_dtype":
        idx = idx.long()
    elif bad == "noncontiguous":
        src = torch.zeros((F, V)).t()
    else:
        fmask = fmask[:-1]
    with pytest.raises((TypeError, ValueError)):
        masked_gather(src, idx, fmask)
