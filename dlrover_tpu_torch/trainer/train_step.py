"""Sharded training step with gradient accumulation.

Counterpart of ``dlrover_tpu/trainer/train_step.py``. The JAX package
lays the whole state out by logical-axis rules over its mesh and lets
XLA insert the collectives; here the same rules
(``parallel/sharding.py``) place each parameter on the port's mesh
(``parallel/mesh.py``):

- **tensor**: ``distribute_tensor`` of each parameter by its placements
  over the ``tensor`` axis, so DTensor propagates the products (column-
  and row-parallel matmuls, the vocabulary-sharded embedding and head)
  and the model code does not change per strategy;
- **fsdp**: FSDP2 ``fully_shard`` over the ``fsdp`` axis, each parameter
  sharded on its ``embed`` dim as the rule ``("embed", fsdp)`` says; a
  parameter with no such dim, or one the axis does not divide, stays
  replicated and its gradient is averaged over the data axes here;
- **data, dcn**: the replicate dimension of HSDP (replicate × shard):
  the gradient is the exact mean over all of (dcn, data, fsdp), which
  equals the JAX package's hierarchical mean of equal-size slice means.

Micro-batches run in a Python loop (the reference's ``lax.scan``); each
rank takes its block of every micro-batch's rows (``shard_batch``), the
gradients are summed in the parameters' f32 ``.grad`` (reduced across
ranks once, after the last micro-batch) and divided by ``accum_steps``.
The metrics, the same on every rank, are the mean loss and the global
gradient norm of the averaged gradients before the optimizer update
(optax's ``global_norm``). Where JAX returns a new immutable state, the
model and optimizer are updated in place, so the parameters and moments
are never held twice. A single-process mesh places nothing: that
trainer is the single-device one.

Not ported yet, and raising: ``sequence`` (ROADMAP Queue A item 8),
``expert`` and ``pipe`` (item 10) axes above 1, and
``grad_reduce_bits`` (item 9).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from dlrover_tpu_torch.common.constants import MeshAxis
from dlrover_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    data_axes,
    dp_index,
    dp_size,
)
from dlrover_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    mesh_placements,
    to_local,
)


@dataclasses.dataclass
class TrainState:
    """The reference's (step, params, opt_state): the parameters live in
    ``model``, the optimizer state in ``optimizer``."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖g‖²) over every gradient, whatever its placement: one
    ``get_total_norm`` per (mesh, placements) group, each made whole
    across the ranks that hold its shards."""
    groups: Dict[Any, List[torch.Tensor]] = {}
    for g in grads:
        key = ((g.device_mesh, tuple(g.placements))
               if isinstance(g, DTensor) else None)
        groups.setdefault(key, []).append(g)
    norms = []
    for group in groups.values():
        norm = torch.nn.utils.get_total_norm(group, foreach=True)
        norms.append(norm.full_tensor() if isinstance(norm, DTensor)
                     else norm)
    if len(norms) == 1:
        return norms[0]
    return torch.linalg.vector_norm(torch.stack(norms))


def _init_optimizer_state(opt: torch.optim.Optimizer) -> None:
    """Give an Adam-family optimizer its per-parameter state without a
    step and without running a kernel (empty moments): the restore
    target that a checkpoint overwrites. Other optimizers are left to
    ``torch.distributed.checkpoint.state_dict``, which initializes them
    with a zero-learning-rate step."""
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        return
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state[p]
            if state:
                continue
            state["step"] = (
                torch.zeros((), dtype=torch.float32, device=p.device)
                if group["capturable"] or group["fused"]
                else torch.tensor(0.0, dtype=torch.float32))
            names = ["exp_avg", "exp_avg_sq"] + (
                ["max_exp_avg_sq"] if group["amsgrad"] else [])
            for name in names:
                state[name] = torch.empty_like(
                    p, memory_format=torch.preserve_format)


@dataclasses.dataclass
class Trainer:
    """init / abstract_state / step / shard_batch for one (model,
    optimizer, mesh)."""

    mesh: Mesh
    model_factory: Callable[..., nn.Module]
    optimizer_factory: Callable[..., torch.optim.Optimizer]
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    accum_steps: int
    micro_batch: int              # global: the sum over the data axes
    rules: List[Tuple[str, Any]]
    offload_opt_state: bool = False
    split_grad_apply: bool = False
    # the CUDA libraries a step launches kernels from (precompile)
    libraries: Tuple[str, ...] = ()
    precompile_timings: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # host wall time of the last step()/grad_step() and shard_batch()
    last_step_dispatch_s: float = 0.0
    last_shard_batch_s: float = 0.0
    # host buffers of the offloaded moments, one per (parameter, name)
    _host: Dict[Tuple[int, str], torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # -- state -------------------------------------------------------------
    def init(self, seed: int = 0) -> TrainState:
        model = self._place(self.model_factory(device=self.device,
                                               seed=seed))
        return TrainState(step=0, model=model,
                          optimizer=self.optimizer_factory(
                              model.parameters()))

    def abstract_state(self) -> TrainState:
        """The restore target: the model built on the ``meta`` device,
        placed on the mesh and then given uninitialized storage on the
        card (no initializer runs, nothing is held twice), and the
        optimizer with empty moments (in host memory when offloaded)."""
        model = self._place(self.model_factory(device="meta", seed=0))
        if any(p.is_meta for p in model.parameters()):
            model.to_empty(device=self.device)
        opt = self.optimizer_factory(model.parameters())
        _init_optimizer_state(opt)
        if self.offload_opt_state:
            self._moments_to_host(opt)
        return TrainState(step=0, model=model, optimizer=opt)

    def _place(self, model: nn.Module) -> nn.Module:
        """Lay the model's parameters over the mesh by the rules (once: a
        placed model passes through)."""
        mesh = self.mesh
        if mesh.device_mesh is None:
            return model
        placements = mesh_placements(model, mesh, self.rules)
        if mesh.shape[MeshAxis.TENSOR] > 1:
            tp_mesh = mesh.submesh([MeshAxis.TENSOR])
            tp = mesh.axis_names.index(MeshAxis.TENSOR)
            for prefix, module in model.named_modules():
                for name, param in list(module.named_parameters(
                        recurse=False)):
                    if isinstance(param, DTensor):
                        continue
                    full = f"{prefix}.{name}" if prefix else name
                    # every rank holds the same full value: each keeps
                    # its own shard, with no communication
                    module.register_parameter(name, nn.Parameter(
                        distribute_tensor(param.detach(), tp_mesh,
                                          [placements[full][tp]],
                                          src_data_rank=None),
                        requires_grad=param.requires_grad))
        from torch.distributed.fsdp import FSDPModule

        if dp_size(mesh) > 1 and not isinstance(model, FSDPModule):
            self._fully_shard(model, placements)
        return model

    def _fully_shard(self, model: nn.Module,
                     placements: Dict[str, list]) -> None:
        from torch.distributed.fsdp import fully_shard

        mesh = self.mesh
        fsdp = mesh.shape[MeshAxis.FSDP]
        column = mesh.axis_names.index(MeshAxis.FSDP)
        shard_dims: Dict[nn.Parameter, Shard] = {}
        ignored: Dict[str, nn.Parameter] = {}
        for name, param in model.named_parameters():
            placement = placements[name][column]
            if (isinstance(placement, Shard)
                    and param.shape[placement.dim] % fsdp == 0):
                shard_dims[param] = placement
            else:
                # sanitize_shardings' rule: a leaf the fsdp rule does not
                # fit stays replicated
                ignored[name] = param
        if mesh.shape[MeshAxis.DCN] > 1:
            replicate = mesh.submesh([MeshAxis.DCN, MeshAxis.DATA])
            dp_mesh = mesh.device_mesh[(replicate.mesh_dim_names[0],
                                        MeshAxis.FSDP)]
        elif mesh.shape[MeshAxis.DATA] > 1:
            dp_mesh = mesh.device_mesh[(MeshAxis.DATA, MeshAxis.FSDP)]
        else:
            dp_mesh = mesh.device_mesh[MeshAxis.FSDP]
        kw = dict(mesh=dp_mesh, shard_placement_fn=shard_dims.get,
                  ignored_params=set(ignored.values()))
        # one FSDP unit per block (a child holding modules), the root
        # takes the rest: a block's parameters are gathered only around
        # its own forward and backward
        for child in model.children():
            if any(True for _ in child.children()):
                fully_shard(child, **kw)
        fully_shard(model, **kw)
        # by name, in parameter order: ``to_empty`` replaces the objects,
        # and the n-th all-reduce must pair the same tensor on each rank
        model.dp_replicated_params = list(ignored)

    # -- the step ----------------------------------------------------------
    def step(self, state: TrainState, tokens: torch.Tensor,
             targets: torch.Tensor) -> Tuple[TrainState, dict]:
        """One optimizer step over (accum, micro, seq) tokens/targets.
        Returns the state and ``{"loss", "grad_norm"}`` as 0-d tensors
        (reading them waits for the device)."""
        t0 = time.monotonic()
        try:
            loss = self._accumulate(state, tokens, targets)
            grad_norm = self._apply(state)
            return state, {"loss": loss, "grad_norm": grad_norm}
        finally:
            self.last_step_dispatch_s = time.monotonic() - t0

    def grad_step(self, state: TrainState, tokens: torch.Tensor,
                  targets: torch.Tensor
                  ) -> Tuple[Dict[str, torch.Tensor], dict]:
        """Forward and backward only: (the in-world mean gradients by
        parameter name, in the parameters' dtype; ``{"loss"}``). Only on
        trainers built with ``split_grad_apply=True``."""
        if not self.split_grad_apply:
            raise RuntimeError("trainer was not built with "
                               "split_grad_apply=True")
        t0 = time.monotonic()
        try:
            loss = self._accumulate(state, tokens, targets)
            grads = {name: p.grad for name, p in
                     state.model.named_parameters() if p.grad is not None}
            return grads, {"loss": loss}
        finally:
            self.last_step_dispatch_s = time.monotonic() - t0

    def apply_grads(self, state: TrainState,
                    grads: Dict[str, torch.Tensor]
                    ) -> Tuple[TrainState, dict]:
        """Optimizer update from (reduced) gradients → (state,
        ``{"grad_norm"}``)."""
        if not self.split_grad_apply:
            raise RuntimeError("trainer was not built with "
                               "split_grad_apply=True")
        for name, p in state.model.named_parameters():
            p.grad = grads.get(name)
        return state, {"grad_norm": self._apply(state)}

    def _accumulate(self, state: TrainState, tokens: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
        """The micro-batch loop: leaves the mean gradients in ``.grad``
        and returns the mean loss over the world's rows."""
        from torch.distributed.fsdp import FSDPModule

        model = state.model
        model.zero_grad(set_to_none=True)
        fsdp = isinstance(model, FSDPModule)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        # plain tensors (positions, masks, the batch) meet DTensor
        # parameters as replicated values
        with implicit_replication():
            for i in range(self.accum_steps):
                if fsdp:
                    # reduce the summed gradient once, after the last
                    model.set_requires_gradient_sync(
                        i == self.accum_steps - 1)
                loss = self.loss_fn(model(tokens[i]), targets[i])
                loss.backward()
                loss_sum += to_local(loss.detach()).float()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        group = self._dp_group()
        if group is not None:
            # the parameters FSDP does not manage, and the loss
            dp = dp_size(self.mesh)
            params = dict(model.named_parameters())
            for name in getattr(model, "dp_replicated_params", ()):
                p = params[name]
                if p.grad is not None:
                    dist.all_reduce(to_local(p.grad), group=group)
                    to_local(p.grad).div_(dp)
            dist.all_reduce(loss_sum, group=group)
            loss_sum /= dp
        if self.accum_steps > 1:
            # in place on each shard: FSDP's sharded gradients and the
            # replicated ones are DTensors of other meshes, or tensors
            torch._foreach_div_([to_local(g) for g in grads],
                                float(self.accum_steps))
        return loss_sum / self.accum_steps

    def _apply(self, state: TrainState) -> torch.Tensor:
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        grad_norm = _global_norm(grads)
        opt = state.optimizer
        if self.offload_opt_state:
            self._moments_to_device(opt)
        opt.step()
        if self.offload_opt_state:
            self._moments_to_host(opt)
        state.step += 1
        return grad_norm

    def _dp_group(self):
        if self.mesh.device_mesh is None or dp_size(self.mesh) == 1:
            return None
        return self.mesh.submesh(data_axes(self.mesh)).get_group()

    # -- optimizer-state offload -------------------------------------------
    def _moments(self, opt: torch.optim.Optimizer):
        """(parameter, its state, name, tensor) of every moment: the
        state tensors with a dim (the scalar step counters stay where
        they are)."""
        for param, state in opt.state.items():
            for name, value in state.items():
                if torch.is_tensor(value) and value.ndim > 0:
                    yield param, state, name, value

    def _moments_to_host(self, opt: torch.optim.Optimizer) -> None:
        """Copy each moment into its host buffer (pinned when the card
        is the device, allocated once) and drop the device copy."""
        pin = self.device.type == "cuda"
        for param, state, name, value in list(self._moments(opt)):
            local = to_local(value)
            key = (id(param), name)
            host = self._host.get(key)
            if host is None:
                host = self._host[key] = torch.empty(
                    local.shape, dtype=local.dtype, device="cpu",
                    pin_memory=pin)
            if local.data_ptr() != host.data_ptr():
                host.copy_(local, non_blocking=pin)
            state[name] = _like(value, host)
        if pin:
            # the host copies are what a checkpoint between steps reads
            torch.cuda.current_stream(self.device).synchronize()

    def _moments_to_device(self, opt: torch.optim.Optimizer) -> None:
        for _, state, name, value in list(self._moments(opt)):
            local = to_local(value)
            state[name] = _like(value, local.to(
                self.device, copy=True,
                non_blocking=self.device.type == "cuda"))

    # -- host side ---------------------------------------------------------
    def shard_batch(self, tokens: np.ndarray, targets: np.ndarray
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host numpy (global_batch, seq) → this rank's device tensors
        shaped (accum, micro / dp, seq): its block of each micro-batch's
        rows over the joint data axes (dcn, data, fsdp), as the JAX
        package's batch sharding P(None, (dcn, data, fsdp))."""
        t0 = time.monotonic()
        accum, micro = self.accum_steps, self.micro_batch
        local = micro // dp_size(self.mesh)
        start = dp_index(self.mesh) * local

        def put(x):
            x = np.asarray(x).reshape(accum, micro, *x.shape[1:])
            x = np.ascontiguousarray(x[:, start:start + local])
            return torch.from_numpy(x.astype(np.int64)).to(self.device)

        result = put(tokens), put(targets)
        self.last_shard_batch_s = time.monotonic() - t0
        return result

    def precompile(self) -> None:
        """Build (or load from the build cache) every CUDA library the
        step launches kernels from, each nvcc beside the others, so that
        a restarting worker overlaps the build with its checkpoint read
        (the counterpart of the JAX package's AOT compile). Records
        ``{"build_s"}``; nothing to build off the card."""
        t0 = time.monotonic()
        if self.device.type == "cuda" and self.libraries:
            from dlrover_tpu_torch.ops import _build

            with ThreadPoolExecutor(len(self.libraries)) as pool:
                list(pool.map(_build.load, self.libraries))
        self.precompile_timings = {
            "build_s": round(time.monotonic() - t0, 2)}


def _like(template: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as the shard of a DTensor laid out as ``template``, or
    itself for a plain template."""
    if not isinstance(template, DTensor):
        return local
    return DTensor.from_local(local, template.device_mesh,
                              template.placements, run_check=False,
                              shape=template.shape, stride=template.stride())


def build_trainer(
    model: Union[nn.Module, Callable[..., nn.Module]],
    optimizer_factory: Callable[..., torch.optim.Optimizer],
    mesh: Optional[Mesh],
    sample_batch,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    accum_steps: int = 1,
    micro_batch: int = 1,
    rules: Optional[Sequence] = None,
    offload_opt_state: bool = False,
    grad_reduce_bits: int = 0,
    split_grad_apply: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Trainer:
    """A trainer for (model, optimizer, mesh).

    ``model``: a callable ``(device=, seed=) -> module``
    (``functools.partial(Llama, cfg)``), called by ``init(seed)``, and on
    the ``meta`` device by ``abstract_state``; or a built module, which
    ``init`` moves to the device and trains from its current parameters
    (the seed is then unused).
    ``optimizer_factory(params)`` builds the optimizer, e.g.
    ``lambda p: torch.optim.AdamW(p, lr, betas=(0.9, 0.999), eps=1e-8,
    weight_decay=wd)`` for ``optax.adamw(lr, weight_decay=wd)``.
    ``mesh``: from ``create_mesh``; None builds the single-process mesh
    on ``device`` (the current CUDA device when None; raises without a
    GPU unless ``device="cpu"``).
    ``sample_batch``: one global micro-batch of tokens, (micro_batch,
    seq), for the shape only.
    ``offload_opt_state``: keep the optimizer's moments in host memory
    (pinned) between steps; they cross to the card around each update.
    """
    if mesh is None:
        mesh = create_mesh(device=device)
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
    shape = mesh.shape
    for axis, item in ((MeshAxis.SEQUENCE, "8, parallel/ring_attention.py"),
                       (MeshAxis.EXPERT, "10, parallel/moe.py"),
                       (MeshAxis.PIPE, "10, parallel/pipeline.py")):
        if shape[axis] > 1:
            raise NotImplementedError(
                f"a {axis} axis is not ported yet (ROADMAP Queue A item "
                f"{item})")
    if grad_reduce_bits:
        raise NotImplementedError(
            "grad_reduce_bits is not ported yet (ROADMAP Queue A item 9, "
            "parallel/quant_collectives.py)")
    if isinstance(model, nn.Module):
        module = model

        def model_factory(device, seed):
            return module.to(mesh.device)

        probe = module
    else:
        model_factory = model
        probe = model(device="meta", seed=0)
    rules = list(rules if rules is not None else DEFAULT_RULES)
    _check_tensor_axis(probe, mesh, rules)
    if tuple(sample_batch.shape[:1]) != (micro_batch,):
        raise ValueError(f"sample batch {tuple(sample_batch.shape)} does "
                         f"not hold micro_batch={micro_batch} rows")
    if micro_batch % dp_size(mesh):
        raise ValueError(f"micro batch {micro_batch} does not divide over "
                         f"{dp_size(mesh)} data-parallel ranks")
    libraries = getattr(probe, "kernel_libraries", lambda: ())()
    return Trainer(mesh=mesh, model_factory=model_factory,
                   optimizer_factory=optimizer_factory, loss_fn=loss_fn,
                   accum_steps=accum_steps, micro_batch=micro_batch,
                   rules=rules, offload_opt_state=offload_opt_state,
                   split_grad_apply=split_grad_apply,
                   libraries=tuple(libraries))


def _check_tensor_axis(model: nn.Module, mesh: Mesh, rules) -> None:
    """Every dim the tensor axis shards must divide by it, and a GQA
    model's kv heads too: each rank's query heads must find their kv
    heads among its own."""
    tensor = mesh.shape[MeshAxis.TENSOR]
    if tensor == 1:
        return
    cfg = getattr(model, "config", None)
    for attr in ("num_heads", "num_kv_heads"):
        if cfg is not None and getattr(cfg, attr, tensor) % tensor:
            raise ValueError(f"{attr}={getattr(cfg, attr)} does not divide "
                             f"over tensor={tensor}")
    column = mesh.axis_names.index(MeshAxis.TENSOR)
    shapes = dict(model.named_parameters())
    for name, placements in mesh_placements(model, mesh, rules).items():
        p = placements[column]
        if isinstance(p, Shard) and shapes[name].shape[p.dim] % tensor:
            raise ValueError(f"{name} {tuple(shapes[name].shape)}: dim "
                             f"{p.dim} does not divide over "
                             f"tensor={tensor}")


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
