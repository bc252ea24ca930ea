"""Exact linear sum assignment on the host (counterpart of
``isfusion_tpu/ops/hungarian.py:assign_proposals``).

The reference matches on the CPU with scipy
(``hungarian_assigner.py:136-142``); the JAX package moved the matching
onto the device only because its TPU runtime could not call back to the
host inside ``jit``. The port matches as the reference does:
``assign_batch`` takes every (Q, G) cost matrix of a step, copied from the
device in one copy, and solves each with
``scipy.optimize.linear_sum_assignment``. A device Hungarian is ROADMAP
queue K9.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def assign_proposals(cost_qg: np.ndarray) -> np.ndarray:
    """(Q, G) cost -> (Q,) int64 matched GT column per proposal, -1 where
    unmatched. Needs G <= Q (every GT is matched)."""
    q, g = cost_qg.shape
    out = np.full((q,), -1, np.int64)
    if g == 0:
        return out
    if g > q:
        raise ValueError(f"assign_proposals: {g} GTs for {q} proposals")
    rows, cols = linear_sum_assignment(cost_qg)
    out[rows] = cols
    return out


def assign_batch(costs: torch.Tensor) -> torch.Tensor:
    """(..., Q, G) cost matrices on any device -> (..., Q) int64 matches on
    the same device: one copy to the host, one LSA per matrix, one copy
    back."""
    host = costs.detach().to("cpu", torch.float64).numpy()
    flat = host.reshape((-1,) + host.shape[-2:])
    cols = np.stack([assign_proposals(c) for c in flat]) if len(flat) else \
        np.zeros((0, host.shape[-2]), np.int64)
    return torch.from_numpy(cols.reshape(host.shape[:-1])).to(costs.device)
