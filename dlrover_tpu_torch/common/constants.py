"""Constants the worker reads: the mesh's axis names, the agent's
environment contract, and the emergency-checkpoint window.

Own copy of the parts of the JAX package's ``common/constants.py`` that
the port uses (``MeshAxis``, the per-worker ``NodeEnv`` names) and of
``DefaultValues.EMERGENCY_CKPT_MIN_WINDOW_S``; a test holds each equal to
the original.
"""


class NodeEnv:
    """The environment an agent sets for the training process it spawns."""

    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    WORLD_SIZE = "DLROVER_TPU_WORLD_SIZE"          # number of processes
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"          # this process's rank
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR"   # host:port of rank 0


class MeshAxis:
    """Canonical named mesh axes."""

    # cross-slice data parallelism over the slow fabric: the OUTERMOST
    # axis
    DCN = "dcn"
    DATA = "data"
    FSDP = "fsdp"
    TENSOR = "tensor"
    SEQUENCE = "sequence"
    EXPERT = "expert"
    PIPE = "pipe"

    ALL = ("dcn", "data", "fsdp", "tensor", "sequence", "expert", "pipe")


# the least time before a deadline for which an emergency save starts at
# all (seconds)
EMERGENCY_CKPT_MIN_WINDOW_S = 2.0
