"""ModelContext and AccelerationPlan.

Counterpart of ``dlrover_tpu/auto/model_context.py`` (after atorch's
``ModelContext``): the context carries the model, the optimizer factory,
the dataset and the loss through the optimization passes, which edit the
declarative :class:`AccelerationPlan` (mesh axes, sharding-rule
overrides, dtypes, remat, kernels, accumulation) instead of wrapping the
model; ``accelerate.lower`` builds the trainer from the final plan once.

The model is carried as a factory, ``(device=, seed=) -> module``
(``functools.partial(Llama, cfg)``), which ``build_trainer`` takes: a
config edit replaces the factory's config and allocates nothing, and the
planner's analysis builds the model on the ``meta`` device. Only the
lowered trainer's ``init`` materialises it. (The JAX package rebuilds
``type(model)(new_cfg)``, which costs nothing for a flax module; in torch
it would allocate a second model, and one more for every dry-run
candidate.) A built module is accepted too: a config edit then turns it
into a factory that builds the edited model and loads the module's
parameters into it at ``init``.

``devices`` are the job's devices, one a rank of the process group (the
current CUDA device on each rank when None; raises without a GPU unless
given, e.g. ``["cpu"]``). This process trains on its own rank's entry.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dlrover_tpu_torch.common.device import resolve_device


@dataclasses.dataclass
class AccelerationPlan:
    """Everything the final lowering needs, as plain data."""

    # mesh: name → size; data absorbs the remainder when 0
    mesh_dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    # logical-axis → mesh-axis overrides appended to the rule table
    rule_overrides: List[Tuple[str, Optional[str]]] = dataclasses.field(
        default_factory=list)
    fsdp: bool = False
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    # "ring" (KV rotation) | "ulysses" (all-to-all head parallel)
    sequence_impl: str = "ring"
    expert_parallel: bool = False
    pipeline_stages: int = 1
    # circular (interleaved) schedule: layer chunks per stage; 1 = GPipe
    pipeline_rounds: int = 1
    compute_dtype: Optional[torch.dtype] = None   # bf16 for half/amp
    params_dtype: Optional[torch.dtype] = None    # f32 master params (amp)
    remat: bool = False
    remat_policy: str = ""      # "" | "full" | "dots" | "nothing_saveable"
    flash_attention: bool = False
    accum_steps: int = 1
    micro_batch: int = 0        # 0 = derive from the global batch
    global_batch: int = 0
    # the JAX plan's buffer donation; the port's step updates in place
    donate_state: bool = True
    # optimizer moments in pinned host memory between steps
    offload_optimizer: bool = False
    # 8/4 = int-quantized gradient all-reduce; 0 = exact
    grad_reduce_bits: int = 0
    # 1F1B-style live-activation bound for the pipeline
    pipeline_bound_activations: bool = False
    # per-layer streaming backward+update on ONE device
    streaming: bool = False
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


def default_optimizer(params) -> torch.optim.Optimizer:
    """``optax.adamw(3e-4)``: its default weight decay is 1e-4."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _rebuilt(cls, config, module: nn.Module, device=None,
             seed: int = 0) -> nn.Module:
    """``cls(config)`` holding ``module``'s parameters (cast to the new
    config's dtypes); on ``meta`` only the structure."""
    model = cls(config, device=device, seed=seed)
    if torch.device(device if device is not None else "cpu").type != "meta":
        model.load_state_dict(module.state_dict())
    return model


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ModelContext:
    """The mutable carrier through the optimization passes."""

    def __init__(
        self,
        model: Union[nn.Module, Callable[..., nn.Module]],
        optim_factory: Optional[Callable[..., Any]] = None,
        dataset: Optional[Any] = None,
        loss_fn: Optional[Callable] = None,
        sample_batch: Optional[Any] = None,
        optim_args: Optional[dict] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        self.model = model
        self.optim_factory = optim_factory
        self.optim_args = dict(optim_args or {})
        self.dataset = dataset
        self.loss_fn = loss_fn
        self.sample_batch = sample_batch
        world, _ = _world()
        self.devices = [torch.device(d) for d in devices] \
            if devices is not None else [resolve_device(None)] * world
        self.plan = AccelerationPlan()

    @property
    def device(self) -> torch.device:
        """This rank's device (the current CUDA device, or the CPU)."""
        _, rank = _world()
        device = self.devices[min(rank, len(self.devices) - 1)]
        return resolve_device(device)

    # -- model-config editing (models expose a dataclass config) ---------
    def _config_slot(self):
        """Where the model's dataclass config sits: (positional index or
        keyword of the factory, config), or (None, the built module's
        config), or (None, None)."""
        model = self.model
        is_config = (lambda c: dataclasses.is_dataclass(c)
                     and not isinstance(c, type))
        if isinstance(model, functools.partial):
            for i, arg in enumerate(model.args):
                if is_config(arg):
                    return i, arg
            for key in ("config", "cfg"):
                if is_config(model.keywords.get(key)):
                    return key, model.keywords[key]
            return None, None
        for attr in ("config", "cfg"):
            if is_config(getattr(model, attr, None)):
                return None, getattr(model, attr)
        return None, None

    def model_config(self):
        return self._config_slot()[1]

    def replace_model_config(self, **updates):
        """Apply the SUPPORTED subset of ``updates`` to the model's
        dataclass config (a config missing one field must not lose the
        others). Returns the skipped keys (empty: everything applied),
        or None when the model has no dataclass config."""
        slot, cfg = self._config_slot()
        if cfg is None:
            return None
        valid = {f.name for f in dataclasses.fields(cfg)}
        usable = {k: v for k, v in updates.items() if k in valid}
        if usable:
            new_cfg = dataclasses.replace(cfg, **usable)
            model = self.model
            if isinstance(slot, int):
                args = list(model.args)
                args[slot] = new_cfg
                self.model = functools.partial(model.func, *args,
                                               **model.keywords)
            elif slot is not None:
                self.model = functools.partial(
                    model.func, *model.args,
                    **{**model.keywords, slot: new_cfg})
            else:
                self.model = functools.partial(_rebuilt, type(model),
                                               new_cfg, model)
        return sorted(set(updates) - set(usable))

    def abstract_model(self) -> nn.Module:
        """The model built on the ``meta`` device (nothing allocated), or
        the built module itself."""
        if isinstance(self.model, nn.Module):
            return self.model
        return self.model(device="meta", seed=0)

    def make_optimizer(self):
        """The optimizer factory's product: a ``params -> Optimizer``
        callable for the dense and pipelined trainers, or a
        ``LeafTransform`` (``dlrover_tpu_torch.optim``) for the streaming
        one. Default: AdamW(3e-4), the port's ``optax.adamw(3e-4)``."""
        if self.optim_factory is None:
            return default_optimizer
        return self.optim_factory(**self.optim_args)

    def optimizer_factory(self) -> Callable[..., torch.optim.Optimizer]:
        """:meth:`make_optimizer` as the ``params -> Optimizer`` factory
        the dense and pipelined trainers take (a ``LeafTransform`` runs
        through ``LeafOptimizer``, as optax runs any transform on either
        JAX trainer)."""
        from dlrover_tpu_torch.optim.base import LeafOptimizer, LeafTransform

        made = self.make_optimizer()
        if isinstance(made, LeafTransform):
            return functools.partial(LeafOptimizer, transform=made)
        return made

    def infer_sample_batch(self, micro_batch: int):
        """A (micro_batch, seq)-shaped sample for shape inference."""
        if self.sample_batch is not None:
            sample = np.asarray(self.sample_batch)
            if sample.shape[0] != micro_batch:
                reps = int(np.ceil(micro_batch / sample.shape[0]))
                sample = np.tile(sample, (reps,) + (1,) * (sample.ndim - 1))
                sample = sample[:micro_batch]
            return sample
        raise ValueError("sample_batch is required for lowering")
