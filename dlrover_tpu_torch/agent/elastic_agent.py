"""The training process's side of the agent's contract.

Counterpart of ``dlrover_tpu/agent/elastic_agent.py::init_distributed``
(the rest of the agent is not ported yet): the agent spawns each worker
with ``DLROVER_TPU_WORLD_SIZE``, ``DLROVER_TPU_PROCESS_ID`` and
``DLROVER_TPU_COORDINATOR`` (``host:port`` of rank 0) in its
environment, and the worker joins the process group from them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.device import resolve_device


def init_distributed(device: Optional[Union[str, torch.device]] = None
                     ) -> None:
    """Join the process group from the agent's env contract; a no-op for a
    single process (standalone runs).

    On the card (``device`` None or CUDA) each process first pins its
    card, ``rank % device_count`` unless ``device`` names one, and the
    group runs NCCL for CUDA tensors and gloo for CPU tensors: the
    checkpointer's background saves stage to host memory and need the CPU
    backend. ``device="cpu"`` runs gloo alone.
    """
    world_size = int(os.getenv(NodeEnv.WORLD_SIZE, "1"))
    if world_size <= 1:
        return
    rank = int(os.environ[NodeEnv.PROCESS_ID])
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            resolve_device(device)          # raises, naming device="cpu"
        index = (torch.device(device).index if device is not None
                 else None)
        torch.cuda.set_device(rank % torch.cuda.device_count()
                              if index is None else index)
        backend = "cpu:gloo,cuda:nccl"
    else:
        backend = "gloo"
    # the same generous registration budget as the JAX package: several
    # workers building kernels on one host register late
    timeout = int(os.getenv("DLROVER_TPU_DIST_INIT_TIMEOUT", "600"))
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ[NodeEnv.COORDINATOR_ADDR]}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
