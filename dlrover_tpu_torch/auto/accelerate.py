"""auto_accelerate: strategy → lowered trainer.

Counterpart of ``dlrover_tpu/auto/accelerate.py`` (after atorch's
``auto_accelerate``, atorch/auto/accelerate.py:391, and
``model_transform``, :35). Three modes:

- an explicit strategy (a list, or ``load_strategy_file``): apply the
  passes, lower, return;
- semi-auto (``strategy="auto"``): the engine's search over
  ``SEMIAUTO_STRATEGIES`` scored by dry runs (``engine/``);
- default (None): bf16 with the flash kernels, plus fsdp when the job
  has more than one device.

``lower`` builds the port's trainers: ``build_trainer`` (dense, with
FSDP2 and DTensor tensor parallelism), ``build_pipeline_trainer`` and
``build_streaming_trainer``. ``module_replace`` sets ``attn_impl="flash"``
when this rank's device is a CUDA card and ``"reference"`` on the CPU;
``sequence_parallel`` at a size above 1 sets ``attn_impl`` to the plan's
``sequence_impl`` (``"ring"`` or ``"ulysses"``), over a flash request,
and ``quant_allreduce`` lowers as ``build_trainer``'s
``grad_reduce_bits`` (the pipeline warns and drops it, as the JAX
lowering does). ``tensor_parallel`` lowers as ``build_trainer``'s
tensor axis on every family (GPT's and BERT's head-major fused qkv
included); what ``build_trainer`` does not port yet raises there, naming
its ROADMAP Queue A item.
The streaming branch keeps the per-leaf contract: its optimizer must be
a ``LeafTransform`` (``build_streaming_trainer`` refuses anything else).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from dlrover_tpu_torch.auto.model_context import ModelContext
from dlrover_tpu_torch.auto.opt_lib import OptimizationLibrary
from dlrover_tpu_torch.auto.strategy import (
    Strategy,
    load_strategy,
    normalize_strategy,
    save_strategy,
)
from dlrover_tpu_torch.common.constants import MeshAxis
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.models.llama import LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.parallel.sharding import make_sharding_rules
from dlrover_tpu_torch.trainer.train_step import (
    Trainer,
    build_trainer,
    choose_accumulation,
)


@dataclasses.dataclass
class AccelerateResult:
    """What auto_accelerate hands back: the lowered trainer carries the
    model, optimizer and loss (atorch returns them as a tuple)."""

    trainer: Trainer
    mesh: Any
    model: Any             # the (edited) model factory or module
    strategy: Strategy
    context: ModelContext

    def init(self, seed: int = 0):
        return self.trainer.init(seed)

    def step(self, state, tokens, targets):
        return self.trainer.step(state, tokens, targets)


def default_strategy(n_devices: int) -> Strategy:
    strategy: Strategy = [("half", {}), ("module_replace", {})]
    if n_devices > 1:
        strategy.append(("fsdp", {}))
    return strategy


def apply_strategy(context: ModelContext, strategy: Strategy,
                   opt_lib: Optional[OptimizationLibrary] = None
                   ) -> ModelContext:
    """The model_transform analog (accelerate.py:35-66): run each pass."""
    opt_lib = opt_lib or OptimizationLibrary()
    opt_lib.validate_strategy(strategy)
    for name, config in strategy:
        opt_lib[name].apply(context, config)
    return context


def plan_mesh_spec(context: ModelContext) -> MeshSpec:
    """The plan's mesh over the context's devices (the JAX lowering's
    rule: fsdp without a size absorbs every device no other axis
    claims)."""
    plan = context.plan
    n_devices = len(context.devices)
    dims = dict(plan.mesh_dims)
    unknown = sorted(set(dims) - set(MeshAxis.ALL))
    if unknown:
        raise ValueError(
            f"unknown mesh axes {unknown}; valid axes: {MeshAxis.ALL}")
    if plan.fsdp and dims.get(MeshAxis.FSDP, 0) <= 1:
        fixed = 1
        for axis, size in dims.items():
            if axis != MeshAxis.FSDP:
                fixed *= size
        if n_devices % fixed == 0 and n_devices // fixed > 1:
            dims[MeshAxis.FSDP] = n_devices // fixed
            dims.setdefault(MeshAxis.DATA, 1)
    return MeshSpec(**dims).with_total_devices(n_devices)


def _edit_model(context: ModelContext, spec: MeshSpec) -> None:
    plan = context.plan
    updates = {}
    if plan.compute_dtype is not None:
        updates["dtype"] = plan.compute_dtype
    if plan.params_dtype is not None:
        updates["param_dtype"] = plan.params_dtype
    if plan.flash_attention:
        updates["attn_impl"] = ("flash" if context.device.type == "cuda"
                                else "reference")
    if plan.sequence_parallel and spec.sequence > 1:
        # the sequence is sharded: attention must be the ring or the
        # all-to-all (over a flash request, whose kernel sees one shard)
        updates["attn_impl"] = plan.sequence_impl
    if plan.remat:
        updates["remat"] = True
        if plan.remat_policy:
            updates["remat_policy"] = plan.remat_policy
    if not updates:
        return
    skipped = context.replace_model_config(**updates)
    if skipped is None:
        logger.info(
            "model has no dataclass config; edits %s skipped (the strategy "
            "still shapes the mesh and the shardings)", sorted(updates))
    elif skipped:
        # a partly supported config is a memory-plan hazard: the sizing
        # may have counted on the dropped edit (remat)
        logger.warning(
            "model config does not accept %s; those edits were dropped "
            "(applied: %s)", skipped, sorted(set(updates) - set(skipped)))


def lower(context: ModelContext) -> AccelerateResult:
    """Build the plan's mesh and trainer."""
    plan = context.plan
    n_devices = len(context.devices)
    spec = plan_mesh_spec(context)
    _edit_model(context, spec)

    rules = make_sharding_rules(
        fsdp=plan.fsdp and spec.fsdp > 1,
        tensor=plan.tensor_parallel and spec.tensor > 1,
        extra=plan.rule_overrides,
    )

    # -- batch geometry --------------------------------------------------
    dp = spec.dcn * (spec.data or 1) * spec.fsdp
    if plan.global_batch:
        accum, micro = choose_accumulation(
            plan.global_batch, dp,
            max_micro_per_replica=plan.micro_batch or 64)
    else:
        accum = plan.accum_steps
        micro = plan.micro_batch or dp
    sample = np.asarray(context.infer_sample_batch(micro))
    cfg = context.model_config()
    loss_fn = context.loss_fn or cross_entropy_loss

    if plan.streaming:
        from dlrover_tpu_torch.trainer.streaming import (
            build_streaming_trainer,
        )

        if n_devices > 1 or plan.pipeline_stages > 1:
            raise ValueError(
                "streaming is the single-device >HBM escape hatch; on "
                f"{n_devices} devices use fsdp / pipeline_parallel "
                "instead (they shard the gradient tree across cards)")
        if accum > 1:
            raise ValueError(
                f"streaming cannot gradient-accumulate (accum={accum}): "
                "holding the accumulated full-tree gradients is exactly "
                "the >HBM cost streaming exists to avoid — raise "
                "micro_batch (or drop global_batch) so accum == 1")
        if not isinstance(cfg, LlamaConfig):
            raise NotImplementedError(
                "streaming lowering needs the Llama stack (LlamaConfig); "
                "for other models call dlrover_tpu_torch.trainer."
                "streaming.build_streaming_trainer directly")
        if context.loss_fn not in (None, cross_entropy_loss):
            logger.warning(
                "streaming computes its own chunked cross-entropy head "
                "loss; the provided loss_fn is ignored")
        trainer = build_streaming_trainer(
            cfg, context.make_optimizer(), micro_batch=micro,
            device=context.device)
        return AccelerateResult(trainer=trainer, mesh=trainer.mesh,
                                model=context.model, strategy=[],
                                context=context)

    mesh = create_mesh(spec, context.device)
    if plan.pipeline_stages > 1:
        from dlrover_tpu_torch.models.bert import BertConfig
        from dlrover_tpu_torch.models.gpt import GPTConfig
        from dlrover_tpu_torch.trainer.pipeline_trainer import (
            build_pipeline_trainer,
        )

        if not isinstance(cfg, (LlamaConfig, GPTConfig, BertConfig)):
            raise NotImplementedError(
                "pipeline lowering needs a stacked-block model config "
                "(LlamaConfig, GPTConfig, or BertConfig); for custom "
                "models build a PipelineModelSpec and a PipelinedTrainer "
                "directly (dlrover_tpu_torch.trainer.pipeline_trainer)")
        # the user's global batch is authoritative (accum × micro rows)
        num_micro = (accum if plan.global_batch
                     else max(plan.accum_steps, 2 * plan.pipeline_stages))
        if plan.grad_reduce_bits:
            logger.warning(
                "quant_allreduce is not implemented for the pipeline "
                "trainer: the data-axis gradient reduce stays exact "
                "(grad_reduce_bits=%d ignored under pipeline_parallel)",
                plan.grad_reduce_bits)
        trainer = build_pipeline_trainer(
            cfg, context.optimizer_factory(), mesh,
            num_microbatches=num_micro, micro_batch=micro,
            seq_len=int(sample.shape[-1]), loss_fn=loss_fn,
            num_rounds=plan.pipeline_rounds, remat=plan.remat, rules=rules,
            offload_opt_state=plan.offload_optimizer,
            bound_activations=plan.pipeline_bound_activations)
        return AccelerateResult(trainer=trainer, mesh=mesh,
                                model=context.model, strategy=[],
                                context=context)

    trainer = build_trainer(
        context.model, context.optimizer_factory(), mesh, sample, loss_fn,
        accum_steps=accum, micro_batch=micro, rules=rules,
        offload_opt_state=plan.offload_optimizer,
        grad_reduce_bits=plan.grad_reduce_bits)
    return AccelerateResult(trainer=trainer, mesh=mesh, model=context.model,
                            strategy=[], context=context)


def auto_accelerate(
    model: Any,
    optim_factory: Optional[Callable] = None,
    dataset: Optional[Any] = None,
    loss_fn: Optional[Callable] = None,
    *,
    sample_batch: Optional[Any] = None,
    strategy: Optional[Any] = None,
    load_strategy_file: str = "",
    save_strategy_to_file: str = "",
    global_batch: int = 0,
    micro_batch: int = 0,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    optim_args: Optional[dict] = None,
) -> AccelerateResult:
    """One-call acceleration (atorch auto_accelerate parity).

    ``model``: a ``(device=, seed=) -> module`` factory
    (``functools.partial(Llama, cfg)``) or a built module.
    ``optim_factory(**optim_args)``: returns a ``params -> Optimizer``
    callable (or a ``LeafTransform`` for ``streaming``); None is
    AdamW(3e-4). ``strategy``: None → the default; ``"auto"`` → the
    engine's search; a list → explicit (names or (name, config) pairs).
    ``devices``: the job's devices, one a rank (see ``ModelContext``).
    """
    context = ModelContext(
        model, optim_factory=optim_factory, dataset=dataset,
        loss_fn=loss_fn, sample_batch=sample_batch,
        optim_args=optim_args, devices=devices,
    )
    context.plan.global_batch = global_batch
    context.plan.micro_batch = micro_batch

    if load_strategy_file:
        chosen = load_strategy(load_strategy_file)
    elif strategy == "auto":
        from dlrover_tpu_torch.auto.engine.acceleration_engine import (
            search_strategy,
        )

        chosen = search_strategy(context)
    elif strategy is not None:
        chosen = normalize_strategy(strategy)
    else:
        chosen = default_strategy(len(context.devices))

    apply_strategy(context, chosen)
    result = lower(context)
    result.strategy = chosen
    if save_strategy_to_file:
        save_strategy(chosen, save_strategy_to_file)
    return result
