"""Training step with gradient accumulation on one device.

Counterpart of ``dlrover_tpu/trainer/train_step.py`` without the mesh:
micro-batches run in a Python loop (the reference's ``lax.scan``), their
gradients summed in f32 (the f32 parameters' ``.grad``) and divided by
``accum_steps``; the metrics are the mean loss and the global gradient
norm of the averaged gradients, taken before the optimizer update
(optax's ``global_norm``). Where JAX returns a new immutable state, the
model and optimizer here are updated in place, so the parameters and
moments are never held twice.

Sharding (``parallel/mesh.py``, ``parallel/sharding.py``),
``split_grad_apply`` and ``grad_reduce_bits`` are later slices of the
port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from dlrover_tpu_torch.common.device import resolve_device


@dataclasses.dataclass
class TrainState:
    """The reference's (step, params, opt_state): the parameters live in
    ``model``, the optimizer state in ``optimizer``."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


@dataclasses.dataclass
class Trainer:
    """init / step / shard_batch for one (model, optimizer, device)."""

    device: torch.device
    model_factory: Callable[..., nn.Module]
    optimizer_factory: Callable[..., torch.optim.Optimizer]
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    accum_steps: int
    micro_batch: int

    def init(self, seed: int = 0) -> TrainState:
        model = self.model_factory(device=self.device, seed=seed)
        return TrainState(step=0, model=model,
                          optimizer=self.optimizer_factory(
                              model.parameters()))

    def step(self, state: TrainState, tokens: torch.Tensor,
             targets: torch.Tensor) -> Tuple[TrainState, dict]:
        """One optimizer step over (accum, micro, seq) tokens/targets.
        Returns the state and ``{"loss", "grad_norm"}`` as 0-d device
        tensors (reading them waits for the device)."""
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(self.accum_steps):
            loss = self.loss_fn(model(tokens[i]), targets[i])
            loss.backward()
            loss_sum += loss.detach().float()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if self.accum_steps > 1:
            torch._foreach_div_(grads, float(self.accum_steps))
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        opt.step()
        state.step += 1
        return state, {"loss": loss_sum / self.accum_steps,
                       "grad_norm": grad_norm}

    def shard_batch(self, tokens: np.ndarray, targets: np.ndarray
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host numpy (global_batch, seq) → device tensors shaped
        (accum, micro, seq)."""
        accum, micro = self.accum_steps, self.micro_batch

        def put(x):
            x = np.asarray(x).reshape(accum, micro, *x.shape[1:])
            return torch.from_numpy(x.astype(np.int64)).to(self.device)

        return put(tokens), put(targets)


def build_trainer(
    model_factory_or_model: Union[nn.Module, Callable[..., nn.Module]],
    optimizer_factory: Callable[..., torch.optim.Optimizer],
    sample_batch,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    accum_steps: int = 1,
    micro_batch: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> Trainer:
    """A trainer for one device (the current CUDA device when None; raises
    without a GPU unless ``device="cpu"``).

    ``model_factory_or_model``: a callable ``(device=, seed=) -> module``
    (``functools.partial(Llama, cfg)``), called by ``init(seed)``; or a
    built module, which ``init`` moves to the device and trains from its
    current parameters (the seed is then unused).
    ``optimizer_factory(params)`` builds the optimizer, e.g.
    ``lambda p: torch.optim.AdamW(p, lr, betas=(0.9, 0.999), eps=1e-8,
    weight_decay=wd)`` for ``optax.adamw(lr, weight_decay=wd)``.
    ``sample_batch``: one micro-batch of tokens, (micro_batch, seq), for
    the shape only.
    """
    device = resolve_device(device)
    if isinstance(model_factory_or_model, nn.Module):
        module = model_factory_or_model

        def model_factory(device, seed):
            return module.to(device)
    else:
        model_factory = model_factory_or_model
    if tuple(sample_batch.shape[:1]) != (micro_batch,):
        raise ValueError(f"sample batch {tuple(sample_batch.shape)} does "
                         f"not hold micro_batch={micro_batch} rows")
    return Trainer(device=device, model_factory=model_factory,
                   optimizer_factory=optimizer_factory, loss_fn=loss_fn,
                   accum_steps=accum_steps, micro_batch=micro_batch)


def choose_accumulation(global_batch: int, dp_size: int,
                        max_micro_per_replica: int) -> Tuple[int, int]:
    """Pick (accum_steps, micro_batch_global) holding the global batch fixed
    as the world resizes (reference: ElasticTrainer trainer.py:225 —
    acc = max_workers / cur_workers).

    micro_batch_global = global_batch / accum must divide by dp_size and fit
    per-replica memory (micro/dp ≤ max_micro_per_replica).
    """
    if global_batch % dp_size:
        raise ValueError(
            f"global batch {global_batch} not divisible by dp size {dp_size}"
        )
    per_replica_total = global_batch // dp_size
    accum = 1
    while (per_replica_total % accum
           or per_replica_total // accum > max_micro_per_replica):
        accum += 1
        if accum > per_replica_total:
            accum = per_replica_total
            break
    return accum, global_batch // accum
