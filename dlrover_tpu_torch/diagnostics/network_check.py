"""Network check: a 2-round paired probe of the cards and the fabric, and
straggler detection.

Counterpart of ``dlrover_tpu/diagnostics/network_check.py`` (after
dlrover's ``--network-check``: the agent runs a diagnostic task before
training, elastic_agent/torch/training.py:681-874; the probe task,
trainer/torch/run_network_check.py:30-92, runs a matmul and a repeated
allgather and writes its elapsed time to a file). The master
(``master/rendezvous.py::NetworkCheckRendezvousManager``) groups the
nodes in pairs, adjacent in round 0 and fastest-with-slowest in round 1,
finds a node that fails both rounds faulty, and flags elapsed > 2×median
as a straggler.

The probe is a process, ``python -m
dlrover_tpu_torch.diagnostics.network_check``, that the agent starts
once for both rounds (the JAX package starts one a round: a JAX process
initializes one distributed runtime; a torch process leaves its group
with ``destroy_process_group`` and joins the next, and so pays its torch
import and card start-up, ≈15 s on a card's host, once). For each round
it joins the pair's process group through
``agent/elastic_agent.py::init_distributed`` (NCCL for the card's tensors,
gloo on the CPU), runs a bf16 matmul burst (4096² on the card, 512² on
the CPU) and, when the group holds more than one rank, repeated
``all_gather_into_tensor`` over it, and answers the elapsed seconds,
which the agent reports to the master. One untimed burst (and gather)
runs first, so the timed window compares execution, not start-up. The
probe runs on the card unless the agent is asked for the CPU
(``run --device cpu``). NCCL puts no two ranks on one card, so pairs of
nodes on one host run on gloo CPU ranks.

The agent's side imports no torch: only the probe process does.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional, Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.bootstrap import publish_or_wait_coordinator
from dlrover_tpu_torch.common.constants import NodeEnv, RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger

_DEVICE_ENV = "DLROVER_TPU_NC_DEVICE"
_MATMUL_SIZE = 4096
_CPU_MATMUL_SIZE = 512
_ALLGATHER_FLOATS = 1 << 20
_ROUNDS = 2
_REPEATS = 10


# ---------------------------------------------------------------------------
# Probe process
# ---------------------------------------------------------------------------

# the prefix of the probe process's replies on its stdout
_REPLY = "network-check-result "


def _probe(device: Optional[str]) -> float:
    """One round in the pair's group (joined from the env contract, left
    at the end): the elapsed seconds of the timed window."""
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.agent.elastic_agent import init_distributed
    from dlrover_tpu_torch.common.device import resolve_device

    init_distributed(device)
    dev = resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    # the matmul burst is the card's sanity: 4096³ in bf16 on the CPU
    # would starve a loaded host, so it is small there
    size = _MATMUL_SIZE if dev.type == "cuda" else _CPU_MATMUL_SIZE
    x = torch.ones((size, size), dtype=torch.bfloat16, device=dev)
    block = torch.ones(_ALLGATHER_FLOATS, dtype=torch.float32, device=dev)
    gathered = torch.empty(n * _ALLGATHER_FLOATS, dtype=torch.float32,
                           device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def burst():
        y = x
        for _ in range(3):
            y = torch.tanh(y @ y * 1e-4)
        return y

    def gather():
        dist.all_gather_into_tensor(gathered, block)

    try:
        # untimed: the first burst and gather pay the libraries' and the
        # communicators' start-up, which the straggler rule must not see
        burst()
        if n > 1:
            gather()
        sync()
        t0 = time.perf_counter()
        burst()
        sync()
        if n > 1:
            for _ in range(_REPEATS):
                gather()
            sync()
            total = float(gathered.sum())
            expected = float(n * _ALLGATHER_FLOATS)
            if abs(total - expected) > 1e-3 * expected:
                raise RuntimeError(f"allgather result {total} != {expected}")
        return time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def probe_main() -> int:
    """Entry of ``python -m dlrover_tpu_torch.diagnostics.network_check``:
    imports torch once, then serves rounds. Each line on stdin is a
    round's group (``{"world_size", "process_id", "coordinator"}``); each
    reply on stdout is ``network-check-result {"elapsed": s}`` (or
    ``{"error": ...}``). Ends at the end of stdin."""
    device = os.environ.get(_DEVICE_ENV) or None
    import torch  # noqa: F401 (paid once, before the first round)

    for line in sys.stdin:
        if not line.strip():
            continue
        request = json.loads(line)
        os.environ.update({
            NodeEnv.WORLD_SIZE: str(request["world_size"]),
            NodeEnv.PROCESS_ID: str(request["process_id"]),
            NodeEnv.COORDINATOR_ADDR: request["coordinator"],
        })
        try:
            reply = {"elapsed": _probe(device)}
        except Exception as e:  # noqa: BLE001 - the round failed
            logger.exception("network check probe failed")
            reply = {"error": repr(e)}
        print(_REPLY + json.dumps(reply), flush=True)
    return 0


class _ProbeProcess:
    """The agent's handle on the probe process: started once, so both
    rounds share its torch import and card start-up."""

    def __init__(self, device: Optional[str]):
        import queue
        import threading

        env = dict(os.environ)
        if device:
            env[_DEVICE_ENV] = device
        self._proc = subprocess.Popen(
            [sys.executable, "-m",
             "dlrover_tpu_torch.diagnostics.network_check"],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        self._replies: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._read, daemon=True,
                         name="network-check-probe").start()

    def _read(self) -> None:
        for line in self._proc.stdout:
            if line.startswith(_REPLY):
                self._replies.put(json.loads(line[len(_REPLY):]))
        self._replies.put({"error": f"probe process exited "
                                    f"{self._proc.wait()}"})

    def run(self, world_size: int, process_id: int, coordinator: str,
            timeout_s: float) -> Tuple[bool, float]:
        """One round: (normal, elapsed); a round that does not answer
        within ``timeout_s`` fails and ends the process."""
        import queue

        try:
            self._proc.stdin.write(json.dumps({
                "world_size": world_size, "process_id": process_id,
                "coordinator": coordinator}) + "\n")
            self._proc.stdin.flush()
            reply = self._replies.get(timeout=timeout_s)
        except (OSError, queue.Empty):
            self.close(kill=True)
            return False, 0.0
        if "elapsed" not in reply:
            logger.warning("network check: probe failed: %s",
                           reply.get("error"))
            return False, 0.0
        return True, float(reply["elapsed"])

    @property
    def alive(self) -> bool:
        return self._proc.poll() is None

    def close(self, kill: bool = False) -> None:
        if kill and self.alive:
            self._proc.kill()
        try:
            self._proc.stdin.close()
        except OSError:
            pass
        try:
            self._proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()


# ---------------------------------------------------------------------------
# Agent-side driver
# ---------------------------------------------------------------------------


def _probe_round(client: MasterClient, devices_per_node: int,
                 timeout_s: float, probe: "_ProbeProcess",
                 after_round: int = -1) -> Tuple[bool, float, int]:
    """Join one network-check round, run the probe in the pair's group:
    (normal, elapsed, the rendezvous round it ran in). Only a round
    after ``after_round`` counts: until the partner joins again, the
    master still answers with the previous round's world, whose
    coordinator is gone."""
    rdzv = RendezvousName.NETWORK_CHECK
    client.join_rendezvous(devices_per_node, rdzv)
    deadline = time.time() + timeout_s
    while True:
        rdzv_round, group, world = client.get_comm_world(rdzv)
        if (world and client.node_rank in world
                and rdzv_round > after_round):
            break
        if time.time() > deadline:
            # withdraw the stale join: a late partner must not complete
            # this round against a peer that already gave up. A master
            # hiccup here stays a round failure.
            try:
                client.leave_rendezvous(rdzv)
            except Exception:
                logger.warning("network check: leave_rendezvous failed; "
                               "continuing with round failure",
                               exc_info=True)
            return False, 0.0, after_round
        time.sleep(0.5)

    ranks = sorted(world)
    process_id = ranks.index(client.node_rank)
    try:
        coord = publish_or_wait_coordinator(
            client, f"coord/{rdzv}/{rdzv_round}/{group}", process_id,
            timeout_s,
        )
    except TimeoutError:
        # the pair's rank 0 never published: this round failed for us;
        # the verdict decides faultiness from both rounds
        logger.warning("network check: no coordinator for round %d "
                       "group %d; counting the round as failed",
                       rdzv_round, group)
        return False, 0.0, rdzv_round
    t0 = time.perf_counter()
    normal, elapsed = probe.run(len(ranks), process_id, coord, timeout_s)
    logger.info("network check: the probe's round in rendezvous round %d "
                "took %.1f s", rdzv_round, time.perf_counter() - t0)
    return normal, elapsed, rdzv_round


def run_network_check(client: MasterClient, devices_per_node: int = 1,
                      exclude_straggler: bool = False,
                      timeout_s: float = 300.0,
                      device: Optional[str] = None) -> bool:
    """Run the 2-round probe and ask the master for the verdict: whether
    this node may join training (reference: training.py:681-733).
    ``device``: None (the card) or ``"cpu"``."""
    t0 = time.perf_counter()
    # started before the first join: its torch import overlaps the wait
    # for a partner
    probe = _ProbeProcess(device)
    rdzv_round = -1
    try:
        for check_round in range(_ROUNDS):
            if not probe.alive:
                probe = _ProbeProcess(device)
            normal, elapsed, rdzv_round = _probe_round(
                client, devices_per_node, timeout_s, probe, rdzv_round)
            logger.info("network check round %d: normal=%s elapsed=%.6fs",
                        check_round, normal, elapsed)
            client.report_network_status(normal, elapsed)
    finally:
        probe.close()
    logger.info("network check: %d rounds in %.1f s", _ROUNDS,
                time.perf_counter() - t0)
    verdict = client.get_network_check_verdict()
    if not verdict.normal:
        logger.error("network check: this node is FAULTY (%s)",
                     verdict.reason)
        return False
    if verdict.is_straggler:
        logger.warning("network check: this node is a STRAGGLER")
        if exclude_straggler:
            return False
    return True


if __name__ == "__main__":
    raise SystemExit(probe_main())
