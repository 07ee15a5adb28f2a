"""Optimization library: named, composable acceleration passes.

Counterpart of ``dlrover_tpu/auto/opt_lib`` (after atorch's
OptimizationLibrary, atorch/auto/opt_lib/optimization_library.py:38-53).
The same names, mapped onto the port:

| atorch name        | here               | effect on the plan            |
|--------------------|--------------------|-------------------------------|
| parallel_mode      | parallel_mode      | mesh data dim (DDP ≙ pure DP) |
| zero1/zero2/fsdp   | zero1/zero2/fsdp   | fsdp axis shards params/opt   |
| amp_native         | amp                | bf16 compute, fp32 params     |
| half               | half               | bf16 everywhere               |
| checkpoint         | remat / checkpoint | per-block remat policy        |
| module_replace     | module_replace     | the flash-attention kernels   |
| tensor_parallel    | tensor_parallel    | tensor axis via rule table    |
| pipeline_parallel  | pipeline_parallel  | pipe axis, circular pipeline  |
| mixed_parallel     | mixed_parallel     | arbitrary named dims          |
| ds_3d_parallel     | 3d_parallel        | data×tensor×pipe preset       |
| (sequence module)  | sequence_parallel  | sequence axis ring attention  |
| (moe module)       | expert_parallel    | expert axis all-to-all        |
"""

from dlrover_tpu_torch.auto.opt_lib.library import (
    Optimization,
    OptimizationLibrary,
    SEMIAUTO_STRATEGIES,
)

__all__ = ["Optimization", "OptimizationLibrary", "SEMIAUTO_STRATEGIES"]
