"""isfusion_tpu_torch — the IS-Fusion detector in PyTorch for NVIDIA Hopper.

A port of the JAX package ``isfusion_tpu`` (which stays the reference).
Module paths mirror that package; parameter names follow the reference
mmdet3d ``state_dict`` keys. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another one. Raises when CUDA is asked for (or defaulted to) and is
    missing — nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def upload(model: torch.nn.Module, batch: dict, device) -> dict:
    """The batch as tensors on the model's device; raises if ``device``
    (default: the CUDA card) is not where the parameters are."""
    dev = resolve_device(device)
    pdev = next(model.parameters()).device
    if pdev != dev and not (pdev.type == dev.type == "cuda"
                            and dev.index is None):
        raise RuntimeError(f"model parameters are on {pdev}, the forward "
                           f"was asked to run on {dev}")
    return {k: v.to(pdev) if torch.is_tensor(v)
            else torch.from_numpy(np.array(v)).to(pdev)
            for k, v in batch.items()}
