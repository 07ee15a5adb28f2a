"""Per-leaf gradient transformations and the optimizer that runs them.

The JAX package's optimizers are optax transformations over the whole
parameter tree. Each of them keeps state per leaf and reads nothing of
another leaf, so here each is a :class:`LeafTransform`: an ``init`` of
one parameter's state and an ``update`` of one gradient, with no state
that spans leaves. That is what lets the streaming step
(``trainer/streaming.py``) update a layer as soon as its gradient
exists and free it.

:class:`LeafOptimizer` runs a transform as a ``torch.optim.Optimizer``
(``build_trainer``'s ``optimizer_factory``): the state of every
parameter is made when the optimizer is built, as optax's ``init``
makes it, so a checkpoint restores into it without a step; and a
restored state keeps its own dtypes (torch's ``load_state_dict`` would
cast every floating state tensor, and the int32 counts, to the
parameter's dtype).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Iterable, Tuple

import torch

LeafState = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LeafTransform:
    """One leaf's part of an optax ``GradientTransformation`` ending in
    the learning-rate scaling:

    - ``init(param) -> state``, a dict of tensors;
    - ``update(grad, state, param, lr) -> (update, new state)``, where
      the parameter's next value is ``param + update`` (optax's
      ``apply_updates``).

    ``learning_rate`` is the optimizer's ``lr`` (its param groups')."""

    init: Callable[[torch.Tensor], LeafState]
    update: Callable[[torch.Tensor, LeafState, torch.Tensor, float],
                     Tuple[torch.Tensor, LeafState]]
    learning_rate: float


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """The square root rounded to nearest, as XLA's and CUDA's are.

    torch's vectorised f32 sqrt on the CPU is one ulp off on about a
    sixth of its inputs, which moves a bf16 image or a row's update off
    JAX's bits. The f64 root of an f32 value rounds back to the correctly
    rounded f32 root (53 >= 2·24 + 2 bits)."""
    if t.device.type == "cpu" and t.dtype == torch.float32:
        return t.double().sqrt().to(torch.float32)
    return t.sqrt()


def count_like(param: torch.Tensor) -> torch.Tensor:
    """optax's int32 step count, on the parameter's device."""
    return torch.zeros((), dtype=torch.int32, device=param.device)


class LeafOptimizer(torch.optim.Optimizer):
    """``torch.optim.Optimizer`` over a :class:`LeafTransform`."""

    def __init__(self, params: Iterable[torch.Tensor],
                 transform: LeafTransform):
        if not isinstance(transform, LeafTransform):
            raise TypeError(f"LeafOptimizer takes a LeafTransform, got "
                            f"{type(transform).__name__}")
        super().__init__(params, {"lr": transform.learning_rate})
        self.transform = transform
        with torch.no_grad():
            for group in self.param_groups:
                for p in group["params"]:
                    self.state[p] = transform.init(p.detach())

    @torch.no_grad()
    def apply(self, param: torch.Tensor, grad: torch.Tensor,
              lr: float) -> None:
        """Update one parameter in place from its gradient."""
        update, self.state[param] = self.transform.update(
            grad, self.state[param], param, lr)
        param.add_(update)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self.apply(p, p.grad, group["lr"])
        return loss

    def load_state_dict(self, state_dict) -> None:
        """The saved state by parameter position, each tensor in its own
        dtype on its parameter's device; the groups' hyperparameters from
        the saved ones."""
        params = [p for g in self.param_groups for p in g["params"]]
        saved = state_dict["param_groups"]
        ids = [i for g in saved for i in g["params"]]
        if len(ids) != len(params) or len(saved) != len(self.param_groups):
            raise ValueError(f"a state of {len(ids)} parameters in "
                             f"{len(saved)} groups does not fit "
                             f"{len(params)} in {len(self.param_groups)}")
        by_id = dict(zip(ids, params))
        state = collections.defaultdict(dict)
        for i, leaf in state_dict["state"].items():
            p = by_id[i]
            state[p] = {k: v.to(device=p.device) if torch.is_tensor(v)
                        else v for k, v in leaf.items()}
        self.state = state
        for group, old in zip(self.param_groups, saved):
            group.update({k: v for k, v in old.items() if k != "params"})
