"""Static model analysis and axis sizing feeding strategy planning.

Counterpart of ``dlrover_tpu/auto/engine/analyser.py`` (after atorch's
Analyser and the shard planners that size parallel axes from the model
and the device topology, auto/opt_lib/shard_planners/mip_tp_planner.py:30).
Nothing is materialised: the model is built on the ``meta`` device (the
JAX package's ``jax.eval_shape``), and the optimizer's state is that of
the real optimizer over those parameters, made as the trainer makes its
restore target (``train_step._init_optimizer_state``: Adam's moments as
empty ``meta`` tensors). A device's memory is its card's total
(``torch.cuda.get_device_properties``), 0 (unknown) on the CPU;
``DLROVER_TPU_HBM_BYTES`` wins over both. ``STATE_HBM_FRACTION``,
``ACTIVATION_FACTOR`` and :func:`size_axes` are the JAX package's.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from dlrover_tpu_torch.auto.model_context import ModelContext
from dlrover_tpu_torch.common.constants import NodeEnv

# Fraction of device memory the train state (params + optimizer) may
# claim; the rest is activations, workspace and fragmentation headroom.
STATE_HBM_FRACTION = 0.6
# Rough fwd+bwd live-activation bytes per token per layer, in units of
# hidden_size × activation bytes: residual stream + qkv + attention
# internals + mlp intermediates (SwiGLU ≈ 2.7×hidden) saved for backward.
ACTIVATION_FACTOR = 14.0


def _model_dims(context: ModelContext) -> Dict[str, int]:
    """Transformer dimensions from a dataclass model config when one
    exists (LlamaConfig / GPTConfig / MoE variants)."""
    cfg = context.model_config()
    if cfg is None:
        return {}
    get = lambda *names: next(
        (int(getattr(cfg, n)) for n in names if hasattr(cfg, n)), 0)
    return {
        "hidden_size": get("hidden_size", "n_embd"),
        "num_layers": get("num_layers", "n_layer"),
        "num_heads": get("num_heads", "n_head"),
        "num_kv_heads": get("num_kv_heads", "num_heads", "n_head"),
        "vocab_size": get("vocab_size"),
        "intermediate_size": get("intermediate_size"),
        "num_experts": get("num_experts"),
    }


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def optimizer_state_bytes(optimizer_factory, params) -> int:
    """Bytes of the state ``optimizer_factory(params)`` holds for
    ``params`` (made on ``meta``): Adam's moments and step counters as
    the trainer's restore target makes them, a ``LeafOptimizer``'s as it
    builds them, any other optimizer's after one step on zero gradients
    (on ``meta``, nothing runs)."""
    from dlrover_tpu_torch.trainer.train_step import _init_optimizer_state

    # meta stand-ins: a built module's own parameters are never touched
    params = [torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                 requires_grad=p.requires_grad)
              for p in params]
    opt = optimizer_factory(params)
    _init_optimizer_state(opt)
    if not opt.state:
        for p in params:
            p.grad = torch.zeros_like(p)
        opt.step()
    return sum(_tensor_bytes(v) for state in opt.state.values()
               for v in state.values() if torch.is_tensor(v))


def _train_state_bytes(context: ModelContext, model: torch.nn.Module,
                       param_count: int, param_bytes: int) -> int:
    """params + grads + the ACTUAL optimizer state, measured on the
    ``meta`` model (an Adafactor user must not be sized as if they
    carried f32 Adam moments). Falls back to the Adam-family upper bound
    (~20 B/param: f32 master + 2 f32 moments + grad + f32 accumulator)
    when the optimizer cannot be built over ``meta`` parameters (one
    whose step needs real data)."""
    try:
        factory = context.optimizer_factory()
        opt_bytes = optimizer_state_bytes(factory, model.parameters())
    except Exception:
        return param_count * 20
    # params + one transient same-dtype grad + the f32 gradient
    # accumulator the JAX trainer carries (kept in the formula so both
    # packages size a model alike) + the measured optimizer state
    return 2 * param_bytes + param_count * 4 + opt_bytes


def device_memory_bytes(device: torch.device) -> int:
    """``DLROVER_TPU_HBM_BYTES``, else the card's total memory, else 0."""
    try:
        hbm_bytes = int(os.environ.get("DLROVER_TPU_HBM_BYTES") or 0)
    except ValueError:
        hbm_bytes = 0
    if not hbm_bytes and device.type == "cuda":
        hbm_bytes = torch.cuda.get_device_properties(device).total_memory
    return hbm_bytes


def analyse(context: ModelContext, micro_batch: int = 1) -> Dict[str, Any]:
    sample = np.asarray(context.infer_sample_batch(micro_batch))
    model = context.abstract_model()
    params = list(model.parameters())
    param_count = sum(p.numel() for p in params)
    param_bytes = sum(_tensor_bytes(p) for p in params)
    dtypes = sorted({str(p.dtype).replace("torch.", "") for p in params})
    train_state_bytes = _train_state_bytes(context, model, param_count,
                                           param_bytes)
    hbm_bytes = device_memory_bytes(context.devices[0])
    dims = _model_dims(context)
    seq_len = int(sample.shape[-1]) if sample.ndim >= 2 else 0
    activation_bytes = 0
    if dims.get("hidden_size") and dims.get("num_layers") and seq_len:
        # bf16 activations (2 bytes) saved for backward, per microbatch
        activation_bytes = int(
            micro_batch * seq_len * dims["num_layers"]
            * dims["hidden_size"] * ACTIVATION_FACTOR * 2)
    return {
        "param_count": param_count,
        "param_bytes": param_bytes,
        "param_dtypes": dtypes,
        "train_state_bytes": train_state_bytes,
        "activation_bytes": activation_bytes,
        "seq_len": seq_len,
        "device_hbm_bytes": hbm_bytes,
        "n_devices": len(context.devices),
        # the slices one process group spans (the failure domains a
        # data-axis reduce crosses): a card reports no slice of its own,
        # so the launcher states them
        "n_dcn_granules": max(1, int(
            os.environ.get(NodeEnv.NUM_SLICES) or 1)),
        "fits_one_device": (
            hbm_bytes == 0
            or train_state_bytes < hbm_bytes * STATE_HBM_FRACTION),
        **dims,
    }


def _divisors_of(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def size_axes(info: Dict[str, Any]) -> Dict[str, Any]:
    """Closed-form axis sizing from the analysis (the JAX package's rule,
    after mip_tp_planner.py:30):

    1. fsdp: the smallest divisor of n_devices whose shard of the train
       state fits STATE_HBM_FRACTION of one device's memory.
    2. remat: on when the per-microbatch activations do not fit the
       memory left after the state shard (remat keeps ~2/14 of them).
    3. tensor: only when activations still do not fit after remat, the
       smallest divisor of the remaining devices dividing both num_heads
       and num_kv_heads that makes them fit.
    4. sequence: when they still do not fit, the sequence dim over the
       remaining devices.
    5. expert: for MoE configs, the largest divisor of the remaining
       devices that divides the expert count.
    6. data: whatever devices remain.

    Returns {"fsdp", "tensor", "sequence", "expert", "data", "remat"};
    all 1 when the device memory is unknown, except expert.
    """
    n_devices = info["n_devices"]
    hbm = info["device_hbm_bytes"]

    def _expert_size(remaining: int) -> int:
        experts = info.get("num_experts", 0) or 0
        if experts <= 1 or remaining < 2:
            return 1
        return max((d for d in _divisors_of(remaining)
                    if d <= experts and experts % d == 0), default=1)

    if not hbm or n_devices < 1:
        expert = _expert_size(n_devices or 1)
        return {"fsdp": 1, "tensor": 1, "sequence": 1, "expert": expert,
                "data": max(1, (n_devices or 1) // expert),
                "remat": False}
    state_budget = hbm * STATE_HBM_FRACTION
    state = info["train_state_bytes"]

    fsdp = next((d for d in _divisors_of(n_devices)
                 if state / d <= state_budget), n_devices)

    free_after_state = max(hbm - state / fsdp, hbm * 0.1)
    act_budget = free_after_state * 0.8
    act = float(info.get("activation_bytes", 0))
    remat = bool(act and act > act_budget)
    # remat keeps ~the residual stream: 2/ACTIVATION_FACTOR of the saved
    # activations, recomputing the rest inside each layer
    act_eff = act * (2.0 / ACTIVATION_FACTOR) if remat else act

    tensor = 1
    heads = info.get("num_heads", 0)
    kv_heads = info.get("num_kv_heads", 0) or heads
    if act_eff > act_budget and heads:
        for d in _divisors_of(n_devices // fsdp):
            if d > 1 and heads % d == 0 and kv_heads % d == 0:
                tensor = d
                if act_eff / d <= act_budget:
                    break

    sequence = 1
    seq_len = info.get("seq_len", 0)
    if act_eff / tensor > act_budget and seq_len:
        for d in _divisors_of(n_devices // (fsdp * tensor)):
            if d > 1 and seq_len % d == 0:
                sequence = d
                if act_eff / (tensor * d) <= act_budget:
                    break

    expert = _expert_size(n_devices // (fsdp * tensor * sequence))
    data = n_devices // (fsdp * tensor * sequence * expert)
    return {"fsdp": fsdp, "tensor": tensor, "sequence": sequence,
            "expert": expert, "data": max(1, data), "remat": remat}
