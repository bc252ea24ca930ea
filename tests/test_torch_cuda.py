"""The port's kernels on the card, against their plain PyTorch versions.

Every test needs an NVIDIA GPU with nvcc and skips elsewhere. This file
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact for the gather (a copy); 1e-3 of the max for the tiny
flagship on the card against the CPU (float32, TF32 off: sums run in
another order).
"""
import pytest
import torch

from isfusion_tpu_torch.ops import cuda_build
from isfusion_tpu_torch.ops.gather import masked_gather, masked_gather_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,f,n,kept", [(5000, 64, 27 * 4000, 0.3),
                                        (300, 8, 1, 1.0),
                                        (7, 1536, 999, 0.5)])
def test_masked_gather_kernel_matches_plain_version(card, dtype, v, f, n,
                                                    kept):
    gen = torch.Generator().manual_seed(v + n)
    src = torch.randn((v, f), generator=gen).to(getattr(torch, dtype))
    idx = torch.randint(0, v, (n,), generator=gen, dtype=torch.int32)
    fmask = torch.rand(n, generator=gen) < kept
    src, idx, fmask = src.to(card), idx.to(card), fmask.to(card)
    before = cuda_build.LAUNCHES["masked_gather"]
    got = masked_gather(src, idx, fmask)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["masked_gather"] == before + 1
    assert torch.equal(got, masked_gather_ref(src, idx, fmask))


def test_masked_gather_empty_launches_nothing(card):
    src = torch.randn((10, 8), device=card)
    idx = torch.zeros(0, dtype=torch.int32, device=card)
    fmask = torch.zeros(0, dtype=torch.bool, device=card)
    before = cuda_build.LAUNCHES["masked_gather"]
    assert masked_gather(src, idx, fmask).shape == (0, 8)
    assert cuda_build.LAUNCHES["masked_gather"] == before


def test_masked_gather_rejects_mixed_devices(card):
    src = torch.randn((10, 8), device=card)
    idx = torch.zeros(4, dtype=torch.int32)
    fmask = torch.ones(4, dtype=torch.bool, device=card)
    with pytest.raises(ValueError):
        masked_gather(src, idx, fmask)


def test_tiny_flagship_on_card_matches_cpu(card):
    from isfusion_tpu_torch.flagship import build_isfusion_flagship

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu, batch_fn = build_isfusion_flagship(tiny=True, device="cuda", seed=2)
    cpu, _ = build_isfusion_flagship(tiny=True, device="cpu", seed=2)
    batch = batch_fn(1, seed=5)
    before = cuda_build.LAUNCHES["masked_gather"]
    pg, _ = gpu(batch, mode="feats", device="cuda")
    assert cuda_build.LAUNCHES["masked_gather"] > before
    pc, _ = cpu(batch, mode="feats", device="cpu")
    want = pc["dense_heatmap"]
    err = (pg["dense_heatmap"].cpu() - want).abs().max() / want.abs().max()
    assert err <= 1e-3
