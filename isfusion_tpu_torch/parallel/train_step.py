"""One training step, on one card or data-parallel (counterpart of
``isfusion_tpu/parallel/train_step.py:total_loss`` and ``make_train_step``).

``step = make_train_step(model, optimizer, schedule, grad_clip)``;
``metrics = step(batch, generator)``: sets the step's lr and beta1, runs
the model's ``mode='loss'`` forward in its current mode (``model.train()``
for training), back-propagates the sum of the loss terms, clips the
gradients' global norm and takes the optimizer step. ``metrics`` holds
detached 0-d tensors: ``loss``, every loss term, ``matched_ious`` and
``grad_norm`` (the pre-clip global norm, as ``optax.global_norm``
reports it). The step runs on the model's device and raises if the batch
or the generator lies on another one; all its randomness comes from
``generator``. ``step.state['count']`` is the schedule's step count (a
checkpoint saves it; a resumed run sets it).

In a process group (``parallel/mesh.py:group``, read at each step)
each rank runs the step on its own rows and, after the backward, the
gradients of the optimizer's parameters are averaged over the ranks in
one all-reduce
(the JAX mesh step's ``pmean``): a parameter without a gradient on one
rank counts as zeros there, and keeps no gradient only where no rank
gave it one, as on one card. The averaged gradients are clipped and
stepped, so every rank takes the same update; ``loss`` and the loss
terms are averaged over the ranks too, and ``grad_norm`` is the
averaged gradients' norm. Sync BatchNorms pool their statistics in the
forward (``models/layers.py:BatchNorm``). ``step.state['allreduce_bytes']``
is the size of the last step's all-reduce buffer.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..runner.optim import Schedule, clip_by_global_norm
from .mesh import all_reduce_mean_, group


def total_loss(losses: dict) -> torch.Tensor:
    """Sum of the entries whose key contains 'loss' (mmcv parse_losses;
    the others, e.g. matched_ious, are diagnostics)."""
    return sum(v.sum() for k, v in losses.items() if "loss" in k)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    schedule: Optional[Schedule] = None,
                    grad_clip: Optional[float] = None
                    ) -> Callable[[dict, torch.Generator], dict]:
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = dict(count=0, allreduce_bytes=0)

    def average(losses: dict, loss: torch.Tensor):
        """pmean of the gradients (in place; None where no rank has one),
        the losses and the loss, in one all-reduce; returns the averaged
        losses and loss."""
        had = torch.tensor([p.grad is not None for p in params],
                           dtype=torch.float32, device=loss.device)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        named = dict(losses, loss=loss)
        terms = [v.detach().float().reshape(-1) for v in named.values()]
        state["allreduce_bytes"] = all_reduce_mean_(grads + [had] + terms)
        for p, g, h in zip(params, grads, had.tolist()):
            p.grad = g if h > 0 else None
        named = {k: t.reshape(v.shape).to(v.dtype)
                 for (k, v), t in zip(named.items(), terms)}
        return named, named.pop("loss")

    def step(batch: dict, generator: torch.Generator) -> dict:
        dev = next(model.parameters()).device
        for k, v in batch.items():
            if torch.is_tensor(v) and v.device.type != "cpu" \
                    and v.device != dev:
                raise RuntimeError(f"batch[{k!r}] is on {v.device}, the "
                                   f"model on {dev}")
        if torch.device(generator.device).type != dev.type:
            raise RuntimeError(f"the generator is on {generator.device}, "
                               f"the model on {dev}")
        if schedule is not None:
            schedule.apply(state["count"])
        optimizer.zero_grad(set_to_none=True)
        losses = model(batch, mode="loss", device=dev, generator=generator)
        loss = total_loss(losses)
        loss.backward()
        if group() is not None:
            losses, loss = average(losses, loss)
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = clip_by_global_norm(grads, grad_clip)
        optimizer.step()
        state["count"] += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(loss=loss.detach(), grad_norm=grad_norm.detach())
        return metrics

    step.state = state
    return step
