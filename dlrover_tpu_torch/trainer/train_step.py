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

- **expert**: the leaves with an ``expert`` logical axis (an MoE
  model's experts and router) as DTensors sharded over the ``expert``
  axis; the batch is not sharded over it, so the ranks of an expert
  group see the same tokens and their other gradients agree, and the
  expert leaves' gradients are averaged over the data axes only
  (``parallel/moe.py`` holds the layer's collectives). Under expert ×
  tensor those leaves lie on the 2-D ``(expert, tensor)`` sub-mesh (``wi``
  ``Shard(0)``, ``Shard(2)``; ``wo`` ``Shard(0)``, ``Shard(1)``; the router
  ``Shard(1)``, replicated over tensor), never on the seven-axis mesh,
  and FSDP2 leaves them to the exact mean here.

A model that sows auxiliary losses (``sows_losses``: the MoE family's
router balancing) is called with ``with_losses=True`` and a gating seed
folded from ``RNG_SEED``, the step and the micro-step, and its aux sum is
added to the loss, as the JAX step adds the ``losses`` collection.

- **sequence**: each rank takes its columns of its rows (the JAX
  package's batch sharding ``P(None, data axes, sequence)``) and the
  model's ``"ring"`` or ``"ulysses"`` attention runs over the axis
  (``parallel/ring_attention.py``; the trainer enters its mesh around
  each step, ``use_mesh``, and the positions start at the shard's
  offset). The parameters are replicated over the axis, so their
  gradients are averaged over it too: under FSDP2 the axis is folded
  into the dimension that shards and reduce-scatters (torchtitan's
  ``dp_shard × cp``), else each gradient is all-reduced over it. The
  loss is the mean of the ranks' shard means, the token mean of the
  whole batch (``mlm_loss`` with weights counts the whole rows).
- **dcn** (a mesh spanning slices): the gradient mean is two-level, as
  the JAX step's: exact over the in-slice axes (data, fsdp, sequence:
  FSDP2's reduce-scatter and the replicate all-reduce), then explicit
  over ``dcn`` (``parallel/quant_collectives.quantized_pmean_leaf``,
  quantized when ``grad_reduce_bits`` is set, else the exact mean).
- **grad_reduce_bits** (8 or 4): the gradients' mean over the explicit
  axis (``dcn`` when the mesh spans slices, else ``data``) goes through
  ``parallel/quant_collectives.quantized_pmean`` (the quantize and
  dequantize kernels on the card); every other axis reduces exactly
  first, and FSDP2 then spans the axes that reduce exactly only, so
  that no replicate all-reduce runs beside the explicit one. Under
  FSDP2 the explicit mean groups each rank's local shard by 256, where
  JAX groups the whole leaf; the two agree at fsdp 1.

Under the ``tensor`` axis each row-parallel product's pending sum is
reduced at the projection's output (``parallel/tensor_parallel.py``),
so the residual stream is replicated, whatever the norm; GPT's and BERT's
fused qkv is stored head-major, so its column shard is whole q, k and v
heads (``models/gpt.py``); an MoE model's experts hold M/t columns each
and the expert layer sums their products (``parallel/moe.py``). Every
collective of the step is the port's own (``parallel/collectives.py``)
but the grad norm's scalar all-reduces.

A ``pipe`` axis is the pipelined trainer's
(``trainer/pipeline_trainer.py``, which shares ``TrainState`` and this
trainer's state, offload and batch handling); this one refuses it.
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
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.experimental import implicit_replication

from dlrover_tpu_torch.common.constants import MeshAxis
from dlrover_tpu_torch.parallel.collectives import (
    STAGE_LANES,
    all_reduce_,
    set_lanes,
)
from dlrover_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    data_axes,
    dp_index,
    dp_size,
    use_mesh,
)
from dlrover_tpu_torch.parallel.moe import fold_seed
from dlrover_tpu_torch.parallel.quant_collectives import (
    quantized_pmean_leaf,
)
from dlrover_tpu_torch.parallel.ring_attention import check_ulysses_heads
from dlrover_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    mesh_placements,
    to_local,
)
from dlrover_tpu_torch.parallel.tensor_parallel import reduce_partial


# the seed the stochastic model paths (MoE router jitter) fold the step
# and the micro-step into: the JAX build_trainer's default rng_seed
RNG_SEED = 0


@dataclasses.dataclass
class TrainState:
    """The reference's (step, params, opt_state): the parameters live in
    ``model``, the optimizer state in ``optimizer``."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖g‖²) over every gradient, whatever its placement: the plain
    ones' ``get_total_norm``, and the DTensors' grouped by their mesh and
    the mesh dims they are sharded over, each group's local Σg² summed
    over those dims (one scalar all-reduce a group that is sharded)."""
    plain: List[torch.Tensor] = []
    groups: Dict[Any, List[torch.Tensor]] = {}
    for g in grads:
        if not isinstance(g, DTensor):
            plain.append(g)
            continue
        g = reduce_partial(g)
        dims = tuple(dim for dim, p in enumerate(g.placements)
                     if not p.is_replicate())
        groups.setdefault((g.device_mesh, dims), []).append(g.to_local())
    norms = []
    if plain:
        norms.append(torch.nn.utils.get_total_norm(plain, foreach=True))
    for (mesh, dims), local in groups.items():
        norm = torch.nn.utils.get_total_norm(local, foreach=True)
        if dims:
            norm = DTensor.from_local(
                norm.square(), mesh,
                [Partial() if dim in dims else Replicate()
                 for dim in range(mesh.ndim)],
                run_check=False).full_tensor().sqrt()
        norms.append(norm)
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
    # 8 or 4: the data axis's gradient mean quantized (0: exact)
    grad_reduce_bits: int = 0
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
        self._distribute(model, placements)
        from torch.distributed.fsdp import FSDPModule

        if self._fsdp_size() > 1 and not isinstance(model, FSDPModule):
            self._fully_shard(model, placements)
        return model

    # -- which axes reduce what --------------------------------------------
    @property
    def _explicit_axis(self) -> Optional[str]:
        """The axis whose gradient mean runs explicitly, after the exact
        in-slice mean: ``dcn`` whenever the mesh spans slices (quantized
        or exact, the hierarchical mean), else ``data`` when quantized
        (the reference wraps it only when the axis is above 1)."""
        if self.mesh.shape[MeshAxis.DCN] > 1:
            return MeshAxis.DCN
        if self.grad_reduce_bits and self.mesh.shape[MeshAxis.DATA] > 1:
            return MeshAxis.DATA
        return None

    def _shard_axes(self) -> Tuple[str, ...]:
        """The axes FSDP2 shards over: fsdp, and the sequence axis folded
        in when there is one."""
        if self.mesh.shape[MeshAxis.SEQUENCE] > 1:
            return (MeshAxis.FSDP, MeshAxis.SEQUENCE)
        return (MeshAxis.FSDP,)

    def _exact_axes(self) -> Tuple[str, ...]:
        """The axes a gradient's exact mean runs over: every axis the
        batch is split over, less the explicit one."""
        axes = tuple(axis for axis in data_axes(self.mesh)
                     if axis != self._explicit_axis)
        if self.mesh.shape[MeshAxis.SEQUENCE] > 1:
            axes = axes + (MeshAxis.SEQUENCE,)
        return axes

    def _size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.mesh.shape[axis] for axis in axes]))

    def _fsdp_size(self) -> int:
        """The ranks FSDP2 spans (1: no FSDP2): the axes that reduce
        exactly (HSDP over data when that one does), whenever the batch is
        split over one; with the data axis explicit, only the shard
        axes."""
        if self.mesh.device_mesh is None:
            return 1
        if self._explicit_axis == MeshAxis.DATA:
            return self._size(self._shard_axes())
        return (self._size(self._exact_axes())
                if dp_size(self.mesh) > 1 else 1)

    def _distribute(self, model: nn.Module,
                    placements: Dict[str, list]) -> None:
        """Each parameter as a DTensor in its placements over the mesh's
        ``tensor`` axis (every parameter) and ``expert`` axis (those it
        shards): over the one axis above 1 the parameter has, or the 2-D
        ``(expert, tensor)`` sub-mesh when it has both, never the
        seven-axis mesh (sharding propagation there took minutes a step
        on gloo ranks)."""
        mesh = self.mesh
        tensor = mesh.shape[MeshAxis.TENSOR] > 1
        expert = mesh.shape[MeshAxis.EXPERT] > 1
        if not (tensor or expert):
            return
        column = {axis: mesh.axis_names.index(axis)
                  for axis in (MeshAxis.EXPERT, MeshAxis.TENSOR)}
        for prefix, module in model.named_modules():
            for name, param in list(module.named_parameters(recurse=False)):
                if isinstance(param, DTensor):
                    continue
                full = placements[f"{prefix}.{name}" if prefix else name]
                axes = [MeshAxis.EXPERT] if expert and isinstance(
                    full[column[MeshAxis.EXPERT]], Shard) else []
                if tensor:
                    axes.append(MeshAxis.TENSOR)
                if not axes:
                    continue
                # every rank holds the same full value: each keeps its own
                # shard, with no communication
                module.register_parameter(name, nn.Parameter(
                    distribute_tensor(
                        param.detach(), mesh.submesh(axes, flatten=False),
                        [full[column[axis]] for axis in axes],
                        src_data_rank=None),
                    requires_grad=param.requires_grad))

    def _fully_shard(self, model: nn.Module,
                     placements: Dict[str, list]) -> None:
        from torch.distributed.fsdp import fully_shard

        mesh = self.mesh
        shard_axes = self._shard_axes()
        fsdp = self._size(shard_axes)
        column = mesh.axis_names.index(MeshAxis.FSDP)
        shard_dims: Dict[nn.Parameter, Shard] = {}
        ignored: Dict[str, nn.Parameter] = {}
        for name, param in model.named_parameters():
            placement = placements[name][column]
            # a leaf on the 2-D (expert, tensor) sub-mesh stays out of
            # FSDP2, whose parameters compose with one other mesh dim
            if (isinstance(placement, Shard)
                    and param.shape[placement.dim] % fsdp == 0
                    and not (isinstance(param, DTensor)
                             and param.device_mesh.ndim > 1)):
                shard_dims[param] = placement
            else:
                # sanitize_shardings' rule: a leaf the fsdp rule does not
                # fit stays replicated
                ignored[name] = param
        # the sequence axis folds into the sharding dimension (the
        # parameters are replicated over it, their gradients averaged)
        shard = mesh.submesh(shard_axes).mesh_dim_names[0]
        if (mesh.shape[MeshAxis.DATA] > 1
                and self._explicit_axis != MeshAxis.DATA):
            # HSDP: the data axis reduces exactly beside the shard axes
            # (the dcn axis never: its mean is the explicit one)
            dp_mesh = mesh.device_mesh[(MeshAxis.DATA, shard)]
        else:
            dp_mesh = mesh.device_mesh[shard]
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
        # parameters as replicated values; the models read the sequence
        # axis from the ambient mesh
        with implicit_replication(), use_mesh(self.mesh):
            for i in range(self.accum_steps):
                if fsdp:
                    # reduce the summed gradient once, after the last
                    model.set_requires_gradient_sync(
                        i == self.accum_steps - 1)
                loss = self._micro_loss(model, tokens[i], targets[i],
                                        state.step, i)
                loss.backward()
                loss_sum += to_local(loss.detach()).float()
        for p in model.parameters():
            if p.grad is None:
                # a parameter the loss does not reach (BERT's token-type
                # table without token types): a zero gradient, as jax.grad
                # gives it, so the optimizer still decays and counts it
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in model.parameters()]
        self._reduce_gradients(model)
        group = self._dp_group()
        if group is not None:
            # the loss: the mean over every rank's share of the batch
            all_reduce_([loss_sum], group)
            loss_sum /= dist.get_world_size(group)
        if self.accum_steps > 1:
            # in place on each shard: FSDP's sharded gradients and the
            # replicated ones are DTensors of other meshes, or tensors
            torch._foreach_div_([to_local(g) for g in grads],
                                float(self.accum_steps))
        return loss_sum / self.accum_steps

    def _reduce_gradients(self, model: nn.Module) -> None:
        """Average the summed gradients over every axis the batch is
        split over (FSDP2 has reduced its own leaves): the exact mean over
        ``_exact_axes`` of the leaves FSDP2 does not manage (every leaf
        without FSDP2), then the explicit axis's mean (quantized when
        ``grad_reduce_bits`` is set) of every leaf's local tensor, as the
        reference reduces ``grad_sum`` before dividing by the
        accumulation."""
        if self.mesh.device_mesh is None:
            return
        from torch.distributed.fsdp import FSDPModule

        exact = self._exact_axes()
        size = self._size(exact)
        if isinstance(model, FSDPModule):
            params = dict(model.named_parameters())
            # by name, in parameter order: the n-th all-reduce pairs the
            # same tensor on each rank
            exact_leaves = [params[name] for name in
                            getattr(model, "dp_replicated_params", ())]
        elif size > 1:
            exact_leaves = list(model.parameters())
        else:
            exact_leaves = []
        local = [to_local(p.grad) for p in exact_leaves]
        if local and size > 1:
            all_reduce_(local, self.mesh.submesh(exact).get_group())
            torch._foreach_div_(local, float(size))
        axis = self._explicit_axis
        if axis is not None:
            group = self.mesh.submesh([axis]).get_group()
            n = self.mesh.shape[axis]
            for p in model.parameters():
                g = to_local(p.grad)
                g.copy_(quantized_pmean_leaf(g, group, n,
                                             bits=self.grad_reduce_bits))

    def _micro_loss(self, model: nn.Module, tokens: torch.Tensor,
                    targets: torch.Tensor, step: int, micro: int
                    ) -> torch.Tensor:
        """One micro-batch's loss: the loss function's, plus the aux
        losses of a model that sows them, whose stochastic routing draws
        from a seed folded from ``RNG_SEED``, the step and the micro
        index (the same on every rank and across a restart)."""
        if not getattr(model, "sows_losses", False):
            return self.loss_fn(model(tokens), targets)
        logits, aux = model(tokens, with_losses=True,
                            gating_seed=fold_seed(RNG_SEED, step, micro))
        return self.loss_fn(logits, targets) + aux

    def _apply(self, state: TrainState) -> torch.Tensor:
        grad_norm = self._grad_norm(state.model)
        opt = state.optimizer
        if self.offload_opt_state:
            self._moments_to_device(opt)
        opt.step()
        if self.offload_opt_state:
            self._moments_to_host(opt)
        state.step += 1
        return grad_norm

    def _grad_norm(self, model: nn.Module) -> torch.Tensor:
        return _global_norm([p.grad for p in model.parameters()
                             if p.grad is not None])

    def _dp_group(self):
        """The group of every rank holding a share of the batch (the data
        axes and the sequence axis), or None when this rank holds it all."""
        axes = self._batch_axes()
        if self.mesh.device_mesh is None or self._size(axes) == 1:
            return None
        return self.mesh.submesh(axes).get_group()

    def _batch_axes(self) -> Tuple[str, ...]:
        return data_axes(self.mesh) + (MeshAxis.SEQUENCE,)

    def _stage_lanes(self) -> None:
        """On a gloo group a CUDA tensor crosses through host memory: give
        the groups of the step's collectives (the loss's, the exact and
        the quantized gradient means', the sequence axis's attention)
        their lanes, so that a staged buffer crosses in parts side by
        side (``parallel/collectives.py``); so do the tensor axis's
        pending sums (``parallel/tensor_parallel.py``) and the expert
        layer's (``parallel/moe.py``). Every rank
        builds its trainer at once, so the lanes' groups are created in
        one order."""
        mesh = self.mesh
        if (mesh.device_mesh is None or self.device.type != "cuda"
                or dist.get_backend() != dist.Backend.GLOO):
            return
        axes = [self._batch_axes(), self._exact_axes(),
                (MeshAxis.SEQUENCE,), (MeshAxis.DATA,), (MeshAxis.DCN,),
                (MeshAxis.TENSOR,), (MeshAxis.EXPERT,)]
        for names in dict.fromkeys(axes):
            if self._size(names) > 1:
                set_lanes(mesh.submesh(names).get_group(),
                          mesh.lanes(names, STAGE_LANES))

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
        shaped (accum, micro / dp, seq / sequence): its block of each
        micro-batch's rows over the joint data axes (dcn, data, fsdp) and
        its block of their columns over the sequence axis, as the JAX
        package's batch sharding P(None, (dcn, data, fsdp), sequence). A
        batch already on the device (``data/prefetch.py``) is cut
        there."""
        t0 = time.monotonic()
        accum, micro = self.accum_steps, self.micro_batch
        local = micro // dp_size(self.mesh)
        start = dp_index(self.mesh) * local
        seq_ways = self.mesh.shape[MeshAxis.SEQUENCE]
        seq_index = self.mesh.coordinate()[MeshAxis.SEQUENCE]

        def columns(x):
            width = x.shape[-1] // seq_ways
            return x[..., seq_index * width:(seq_index + 1) * width]

        def put(x):
            if torch.is_tensor(x):
                x = x.reshape(accum, micro, *x.shape[1:])
                return columns(x[:, start:start + local]).to(
                    self.device, torch.int64).contiguous()
            x = np.asarray(x).reshape(accum, micro, *x.shape[1:])
            x = np.ascontiguousarray(columns(x[:, start:start + local]))
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
    ``grad_reduce_bits``: 8 or 4 quantizes the gradients' mean over the
    ``dcn`` axis when the mesh spans slices, else over the data axis
    (``parallel/quant_collectives.py``); 0 is exact.
    ``split_grad_apply``: the step in two halves around the host-level
    cross-slice sync of slice mode (``parallel/dcn_sync.py``):
    ``grad_step`` leaves the in-world mean gradients and returns them,
    ``apply_grads`` applies the fleet mean.
    """
    if mesh is None:
        mesh = create_mesh(device=device)
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
    shape = mesh.shape
    if shape[MeshAxis.PIPE] > 1:
        raise NotImplementedError(
            f"the dense trainer has no {MeshAxis.PIPE} axis: build a "
            f"pipelined one with build_pipeline_trainer "
            f"(trainer/pipeline_trainer.py)")
    if grad_reduce_bits not in (8, 4, 0):
        raise ValueError(f"grad-reduce bits must be 8, 4 or 0, got "
                         f"{grad_reduce_bits}")
    if isinstance(model, nn.Module):
        module = model

        def model_factory(device, seed):
            return module.to(mesh.device)

        probe = module
    else:
        model_factory = model
        probe = model(device="meta", seed=0)
    rules = list(rules if rules is not None else DEFAULT_RULES)
    _check_model_axes(probe, mesh, rules)
    if tuple(sample_batch.shape[:1]) != (micro_batch,):
        raise ValueError(f"sample batch {tuple(sample_batch.shape)} does "
                         f"not hold micro_batch={micro_batch} rows")
    if micro_batch % dp_size(mesh):
        raise ValueError(f"micro batch {micro_batch} does not divide over "
                         f"{dp_size(mesh)} data-parallel ranks")
    _check_sequence_axis(probe, mesh, sample_batch.shape[-1])
    libraries = getattr(probe, "kernel_libraries", lambda: ())()
    trainer = Trainer(mesh=mesh, model_factory=model_factory,
                      optimizer_factory=optimizer_factory, loss_fn=loss_fn,
                      accum_steps=accum_steps, micro_batch=micro_batch,
                      rules=rules, offload_opt_state=offload_opt_state,
                      split_grad_apply=split_grad_apply,
                      grad_reduce_bits=grad_reduce_bits,
                      libraries=tuple(libraries))
    trainer._stage_lanes()
    return trainer


def _check_sequence_axis(model: nn.Module, mesh: Mesh, seq: int) -> None:
    """A sequence axis above 1 needs the model's ``"ring"`` or
    ``"ulysses"`` attention (any other would see only its own shard's
    keys; the JAX package's SPMD would gather them), a length the axis
    divides, and for Ulysses query heads the sequence and tensor axes
    divide (``ValueError``)."""
    ways = mesh.shape[MeshAxis.SEQUENCE]
    if ways == 1:
        return
    cfg = getattr(model, "config", None)
    impl = getattr(cfg, "attn_impl", None)
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"a {MeshAxis.SEQUENCE} axis of {ways} needs "
                         f"attn_impl 'ring' or 'ulysses', got {impl!r}")
    if seq % ways:
        raise ValueError(f"sequence length {seq} does not divide over "
                         f"sequence={ways}")
    heads = getattr(cfg, "num_heads", None) or getattr(cfg, "n_head", None)
    if impl == "ulysses" and heads is not None:
        check_ulysses_heads(heads, ways, mesh.shape[MeshAxis.TENSOR])


def _check_model_axes(model: nn.Module, mesh: Mesh, rules) -> None:
    """Every dim the tensor or the expert axis shards must divide by it
    (``ValueError``): an MoE model's expert count by the expert way, and
    under a tensor axis the heads, the MLP's (or each expert's)
    intermediate width, and a GQA model's kv heads too, since each rank's
    query heads must find their kv heads among its own (GPT's and BERT's
    head-major fused qkv shards into whole heads alike)."""
    expert = mesh.shape[MeshAxis.EXPERT]
    tensor = mesh.shape[MeshAxis.TENSOR]
    if expert == 1 and tensor == 1:
        return
    shapes = dict(model.named_parameters())
    placements = mesh_placements(model, mesh, rules)
    column = mesh.axis_names.index(MeshAxis.EXPERT)
    for name, p in placements.items():
        p = p[column]
        if (expert > 1 and isinstance(p, Shard)
                and shapes[name].shape[p.dim] % expert):
            raise ValueError(f"{name} {tuple(shapes[name].shape)}: dim "
                             f"{p.dim} does not divide over "
                             f"expert={expert}")
    if tensor == 1:
        return
    cfg = getattr(model, "config", None)
    for attr in ("num_heads", "n_head", "num_kv_heads",
                 "intermediate_size"):
        if cfg is not None and getattr(cfg, attr, tensor) % tensor:
            raise ValueError(f"{attr}={getattr(cfg, attr)} does not divide "
                             f"over tensor={tensor}")
    column = mesh.axis_names.index(MeshAxis.TENSOR)
    for name, p in placements.items():
        p = p[column]
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
