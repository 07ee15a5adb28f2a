"""The optimization registry and every built-in pass.

Counterpart of ``dlrover_tpu/auto/opt_lib/library.py``: the same passes
under the same names and aliases, editing the same plan fields, with
``torch`` dtypes where the JAX passes set ``jnp`` ones. Which passes the
port can lower, and which raise there, is ``accelerate.lower``'s
business: a pass only edits the plan.
"""

from __future__ import annotations

from typing import Dict

import torch

from dlrover_tpu_torch.auto.model_context import ModelContext
from dlrover_tpu_torch.common.constants import MeshAxis
from dlrover_tpu_torch.common.log import default_logger as logger


class Optimization:
    """One named pass editing the plan. `distributed` passes need >1
    device to be meaningful; the planner uses this for pruning."""

    name: str = ""
    distributed: bool = False
    # mutually-exclusive group (e.g. only one of zero1/zero2/fsdp)
    group: str = ""

    def apply(self, context: ModelContext, config: dict) -> None:
        raise NotImplementedError


def _set_mesh_dim(context: ModelContext, axis: str, size: int) -> None:
    context.plan.mesh_dims[axis] = size


class ParallelModeOptimization(Optimization):
    """Pure data parallelism (DDP analog). config: {"data": N} or empty
    (data absorbs all devices)."""

    name = "parallel_mode"
    distributed = True

    def apply(self, context, config):
        if "data" in config:
            _set_mesh_dim(context, MeshAxis.DATA, int(config["data"]))


class Zero1Optimization(Optimization):
    """Optimizer-state sharding. The fsdp axis shards params AND optimizer
    state (FSDP2 gathers each block's weights around its use);
    zero1/zero2/fsdp are one pass, kept as separate names for strategy
    parity."""

    name = "zero1"
    distributed = True
    group = "zero"

    def apply(self, context, config):
        context.plan.fsdp = True
        size = int(config.get("size", 0))
        if size:
            _set_mesh_dim(context, MeshAxis.FSDP, size)


class Zero2Optimization(Zero1Optimization):
    name = "zero2"


class FSDPOptimization(Zero1Optimization):
    name = "fsdp"


class AmpOptimization(Optimization):
    """bf16 compute with fp32 master params (native AMP; bf16 has fp32's
    exponent range, so no loss scaling)."""

    name = "amp"

    def apply(self, context, config):
        context.plan.compute_dtype = torch.bfloat16
        context.plan.params_dtype = torch.float32


class HalfOptimization(Optimization):
    """Everything in bf16 (atorch half 'bf16')."""

    name = "half"

    def apply(self, context, config):
        dtype = getattr(torch, config.get("dtype", "bfloat16"))
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"half dtype {config.get('dtype')!r} is not a "
                             f"torch dtype")
        context.plan.compute_dtype = dtype
        context.plan.params_dtype = dtype


class RematOptimization(Optimization):
    """Activation checkpointing of each block under a policy
    (``ops/remat.py``; atorch 'checkpoint')."""

    name = "checkpoint"

    def apply(self, context, config):
        context.plan.remat = True
        context.plan.remat_policy = config.get("policy", "full")


class ModuleReplaceOptimization(Optimization):
    """Swap attention for the port's flash kernels on the card (atorch
    module_replace pairs BertAttention→FlashAttn etc.)."""

    name = "module_replace"

    def apply(self, context, config):
        context.plan.flash_attention = True


class OffloadOptimizerOptimization(Optimization):
    """Optimizer state in host memory (reference: Adam with CPU offload,
    atorch/optim/adam_offload.py): the trainer keeps the moments in
    pinned host memory between steps and moves them around the update."""

    name = "offload_optimizer"

    def apply(self, context, config):
        context.plan.offload_optimizer = True


class StreamingOptimization(Optimization):
    """Per-layer streaming backward+update: train models whose FULL
    gradient tree exceeds one device's memory (reference capability:
    FSDP param/grad sharding and CPU-offloaded Adam). The backward runs
    as a reverse per-layer loop applying the optimizer update in place,
    so peak memory is params + ONE layer's gradients
    (trainer/streaming.py).

    Contract: the Llama stack + a PER-LEAF optimizer (a ``LeafTransform``
    of ``dlrover_tpu_torch.optim``; global-norm clipping does not
    qualify — its norm would be per-layer, changing the math)."""

    name = "streaming"

    def apply(self, context, config):
        context.plan.streaming = True
        logger.info(
            "streaming: per-layer backward+update — the optimizer must "
            "be per-leaf (a LeafTransform: factored_rms/adafactor; "
            "global-norm clipping would become per-layer clipping)")


class QuantizedAllreduceOptimization(Optimization):
    """int8/int4 groupwise gradient all-reduce over the data/DCN axis
    (reference: the quant_reduce CUDA kernel,
    atorch/ops/csrc/quantization/quant_reduce.cu:248). config:
    {"bits": 8|4}."""

    name = "quant_allreduce"
    distributed = True

    def apply(self, context, config):
        bits = int(config.get("bits", 8))
        if bits not in (8, 4):
            raise ValueError(
                f"quant_allreduce bits must be 8 or 4, got {bits}")
        context.plan.grad_reduce_bits = bits


class TensorParallelOptimization(Optimization):
    """Megatron-style TP: column/row splits come from the logical-axis rule
    table, no module surgery. config: {"size": N}."""

    name = "tensor_parallel"
    distributed = True

    def apply(self, context, config):
        context.plan.tensor_parallel = True
        _set_mesh_dim(context, MeshAxis.TENSOR,
                      int(config.get("size", 2)))


class SequenceParallelOptimization(Optimization):
    """Ring attention over a sequence axis (atorch
    DistributedSelfAttention analog). config: {"size": N}."""

    name = "sequence_parallel"
    distributed = True

    def apply(self, context, config):
        context.plan.sequence_parallel = True
        impl = config.get("impl", "ring")
        if impl not in ("ring", "ulysses"):
            raise ValueError(
                f"sequence_parallel impl must be ring|ulysses, got {impl!r}")
        context.plan.sequence_impl = impl
        _set_mesh_dim(context, MeshAxis.SEQUENCE,
                      int(config.get("size", 2)))


class ExpertParallelOptimization(Optimization):
    """MoE expert-parallel axis. config: {"size": N}."""

    name = "expert_parallel"
    distributed = True

    def apply(self, context, config):
        context.plan.expert_parallel = True
        _set_mesh_dim(context, MeshAxis.EXPERT,
                      int(config.get("size", 2)))


class PipelineParallelOptimization(Optimization):
    """Stage-sharded pipeline over the pipe axis. config: {"size": N}."""

    name = "pipeline_parallel"
    distributed = True

    def apply(self, context, config):
        size = int(config.get("size", 2))
        context.plan.pipeline_stages = size
        # rounds > 1 = circular/interleaved schedule (bubble ÷ rounds)
        context.plan.pipeline_rounds = int(config.get("rounds", 1))
        # 1F1B-style live-activation bound (checkpointed step windows)
        context.plan.pipeline_bound_activations = bool(
            config.get("memory_bound", False))
        _set_mesh_dim(context, MeshAxis.PIPE, size)


class MixedParallelOptimization(Optimization):
    """Arbitrary named dims: config {"dims": [["tensor",4],["data",2]]}
    (atorch create_parallel_group spec,
    atorch/distributed/distributed.py:323-334)."""

    name = "mixed_parallel"
    distributed = True

    def apply(self, context, config):
        for name, size in config.get("dims", []):
            _set_mesh_dim(context, name, int(size))
            if name == MeshAxis.FSDP:
                context.plan.fsdp = True
            elif name == MeshAxis.TENSOR:
                context.plan.tensor_parallel = True
            elif name == MeshAxis.SEQUENCE:
                context.plan.sequence_parallel = True
            elif name == MeshAxis.EXPERT:
                context.plan.expert_parallel = True
            elif name == MeshAxis.PIPE:
                context.plan.pipeline_stages = int(size)


class ThreeDParallelOptimization(Optimization):
    """data×tensor×pipe preset (DeepSpeed 3D analog). config:
    {"data": D, "tensor": T, "pipe": P}."""

    name = "3d_parallel"
    distributed = True

    def apply(self, context, config):
        MixedParallelOptimization().apply(context, {"dims": [
            [MeshAxis.DATA, config.get("data", 1)],
            [MeshAxis.TENSOR, config.get("tensor", 2)],
            [MeshAxis.PIPE, config.get("pipe", 2)],
        ]})


class OptimizationLibrary:
    """Name → Optimization registry (atorch
    OptimizationLibrary.register_optimizations)."""

    def __init__(self):
        self.opts: Dict[str, Optimization] = {}
        for opt_cls in (
            ParallelModeOptimization,
            Zero1Optimization,
            Zero2Optimization,
            FSDPOptimization,
            AmpOptimization,
            HalfOptimization,
            RematOptimization,
            ModuleReplaceOptimization,
            TensorParallelOptimization,
            SequenceParallelOptimization,
            ExpertParallelOptimization,
            PipelineParallelOptimization,
            MixedParallelOptimization,
            ThreeDParallelOptimization,
            OffloadOptimizerOptimization,
            QuantizedAllreduceOptimization,
            StreamingOptimization,
        ):
            opt = opt_cls()
            self.opts[opt.name] = opt
        # atorch aliases
        self.opts["remat"] = self.opts["checkpoint"]
        self.opts["amp_native"] = self.opts["amp"]
        self.opts["adam_offload"] = self.opts["offload_optimizer"]

    def __getitem__(self, name: str) -> Optimization:
        return self.opts[name]

    def __contains__(self, name: str) -> bool:
        return name in self.opts

    def validate_strategy(self, strategy) -> None:
        seen_groups: Dict[str, str] = {}
        for name, _ in strategy:
            if name not in self.opts:
                raise ValueError(
                    f"unknown optimization {name!r}; "
                    f"available: {sorted(self.opts)}")
            group = self.opts[name].group
            if group:
                if group in seen_groups:
                    raise ValueError(
                        f"optimizations {seen_groups[group]!r} and "
                        f"{name!r} are mutually exclusive")
                seen_groups[group] = name


# Strategies the semi-auto mode will combine and dry-run (atorch
# SEMIAUTO_STRATEGIES, optimization_library.py:13).
SEMIAUTO_STRATEGIES = (
    "amp",
    "checkpoint",
    "module_replace",
    "fsdp",
    "tensor_parallel",
)
