"""``python -m dlrover_tpu_torch.run``: the elastic launcher CLI.

Own copy of the JAX package's ``run.py``, after
dlrover/trainer/torch/elastic_run.py (the ``dlrover-run`` torchrun
superset: ``--nnodes min:max``, ``--standalone`` auto-spawning a local
master, ``--max-restarts``). One agent per host spawns ONE training
process owning the host's cards.

Usage:
    python -m dlrover_tpu_torch.run --standalone \\
        dlrover_tpu_torch/examples/llama_train.py --config llama_1b
    python -m dlrover_tpu_torch.run --nnodes 2:4 --node-rank $RANK \\
        --master-addr $DLROVER_TPU_MASTER_ADDR train.py
    DLROVER_TPU_MASTER_BOOTSTRAP_FILE=B python -m dlrover_tpu_torch.run \\
        train.py

With no ``--master-addr`` (and no ``DLROVER_TPU_MASTER_ADDR``) the agent
finds the master through the bootstrap file a master started with
``--bootstrap-file B`` publishes, as its master-lost reconnect does; the
worker inherits the file's path through the environment.

``--network-check`` runs the 2-round probe of
``diagnostics/network_check.py`` before the worker starts, on the card
unless ``--device cpu`` asks for the CPU; a node the master finds faulty
(or, with ``--exclude-straggler``, a straggler) does not train, and the
agent exits 3.

``--slice-id S`` (or ``DLROVER_TPU_SLICE_ID``) puts the host in slice S
of a slice-mode job: the slice is the failure domain, with its own
rendezvous world, and the worker syncs gradients across slices through
``parallel/dcn_sync.py``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional, Tuple

from dlrover_tpu_torch.agent.elastic_agent import ElasticAgent, WorkerSpec
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import DefaultValues, NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger


def _parse_nnodes(value: str) -> Tuple[int, int]:
    if ":" in value:
        lo, hi = value.split(":", 1)
        return int(lo), int(hi)
    n = int(value)
    return n, n


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        "dlrover_tpu_torch.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--nnodes", default="1",
                        help="node count, fixed `N` or elastic `MIN:MAX`")
    parser.add_argument("--node-rank", type=int,
                        default=int(os.getenv(NodeEnv.NODE_RANK, "0")))
    parser.add_argument("--slice-id", type=int,
                        default=int(os.getenv(NodeEnv.SLICE_ID, "-1")),
                        help="the slice this host belongs to (slice mode; "
                             "the slice is the failure domain). -1 = a "
                             "sliceless job")
    parser.add_argument("--master-addr",
                        default=os.getenv(NodeEnv.MASTER_ADDR, ""))
    parser.add_argument("--standalone", action="store_true",
                        help="run a local in-process master (single host)")
    parser.add_argument("--max-restarts", type=int,
                        default=DefaultValues.MAX_RELAUNCH)
    parser.add_argument("--monitor-interval", type=float,
                        default=DefaultValues.MONITOR_INTERVAL_S)
    parser.add_argument("--devices-per-node", type=int, default=0,
                        help="local card count (0 = detect)")
    parser.add_argument("--network-check", action="store_true",
                        help="run the card and fabric probe before "
                             "training (reference: dlrover-run "
                             "--network-check)")
    parser.add_argument("--exclude-straggler", action="store_true",
                        help="exit instead of training when this node is "
                             "flagged as a straggler by the probe")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the network check's probe runs (the "
                             "worker script takes its own)")
    parser.add_argument("--node-unit", type=int, default=1)
    parser.add_argument("--no-python", action="store_true",
                        help="run the entrypoint as a raw command")
    parser.add_argument("entrypoint", help="training script (or command)")
    parser.add_argument("entry_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def _detect_devices() -> int:
    """The host's card count, read by ``nvidia-smi -L`` in a subprocess:
    the agent must never create a CUDA context itself (it would hold
    memory on the card its worker trains on). 1 when nothing answers."""
    env = os.getenv(NodeEnv.DEVICES_PER_NODE)
    if env:
        return int(env)
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
        count = sum(1 for line in out.stdout.splitlines()
                    if line.startswith("GPU "))
        return count or 1
    except (OSError, subprocess.SubprocessError):
        return 1


def run(args: argparse.Namespace) -> int:
    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    master = None
    master_addr = args.master_addr
    if args.standalone:
        from dlrover_tpu_torch.master.job_master import JobMaster

        master = JobMaster(min_nodes=min_nodes, max_nodes=max_nodes,
                           node_unit=args.node_unit, host="127.0.0.1")
        master.prepare()
        master_addr = master.addr
        logger.info("standalone master at %s", master_addr)
    if not master_addr:
        master_addr = MasterClient.resolve_master_addr()
    if not master_addr:
        raise SystemExit(
            "--master-addr (or DLROVER_TPU_MASTER_ADDR, or a bootstrap "
            "file in DLROVER_TPU_MASTER_BOOTSTRAP_FILE) is required unless "
            "--standalone"
        )

    entrypoint = list(args.entry_args)
    if args.no_python:
        entrypoint.insert(0, args.entrypoint)
    else:
        entrypoint = [sys.executable, args.entrypoint] + entrypoint

    node_type = os.environ.get(NodeEnv.NODE_TYPE, "worker")
    # NODE_ID diverges from rank after a relaunch (replacement nodes get
    # a fresh id); heartbeats/failures must carry the id the master tracks
    node_id = int(os.environ.get(NodeEnv.NODE_ID, str(args.node_rank)))
    client = MasterClient(master_addr, node_id=node_id,
                          node_rank=args.node_rank, node_type=node_type,
                          slice_id=args.slice_id)
    devices = args.devices_per_node or _detect_devices()
    spec = WorkerSpec(
        entrypoint=entrypoint,
        devices_per_node=devices,
        max_restarts=args.max_restarts,
        monitor_interval_s=args.monitor_interval,
    )
    agent = ElasticAgent(client, spec)
    try:
        if args.network_check:
            from dlrover_tpu_torch.diagnostics.network_check import (
                run_network_check,
            )

            ok = run_network_check(
                client, devices, exclude_straggler=args.exclude_straggler,
                device="cpu" if args.device == "cpu" else None)
            if not ok:
                logger.error("network check verdict: this node must not "
                             "join training")
                return 3
        return agent.run()
    finally:
        agent.shutdown()
        client.close()
        if master is not None:
            master.stop()


def main(argv: Optional[List[str]] = None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
