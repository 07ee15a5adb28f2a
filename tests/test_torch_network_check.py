"""The port's network check (dlrover_tpu_torch.diagnostics.network_check
and ``run --network-check``) against the JAX package's verdicts.

- One launch of two nodes (two agents' drivers in threads, each round's
  probe a gloo process pair on the CPU) against the port's master gives
  two rounds, both normal, and the master's verdicts equal those of the
  JAX package's ``NetworkCheckRendezvousManager`` fed the same reports.
- Scripted reports (a node faulty in both rounds, one in one round, a
  straggler at over 2× the median) give the same fault list, stragglers
  and pairing in both packages' managers, and the same verdict on the
  wire.
- The agent's side: a faulty verdict, and a straggler under
  ``--exclude-straggler``, keep the node out (``run`` exits 3) in both
  packages' drivers alike.
Every comparison is exact: verdicts are booleans and rank lists.
"""

import os
import subprocess
import sys
import threading

import pytest

from dlrover_tpu.diagnostics import network_check as j_nc
from dlrover_tpu.master.rendezvous import (
    NetworkCheckRendezvousManager as JManager,
)
from dlrover_tpu.master.rendezvous import RendezvousParameters as JParams
from dlrover_tpu_torch import run as t_run
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.diagnostics import network_check as t_nc
from dlrover_tpu_torch.master.job_master import JobMaster
from dlrover_tpu_torch.master.rendezvous import (
    NetworkCheckRendezvousManager as TManager,
)
from dlrover_tpu_torch.master.rendezvous import RendezvousParameters as TParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _replay(manager, n, rounds):
    """Feed ``rounds`` ([{rank: (normal, elapsed)}] a round) into a fresh
    manager as the agents do: all join, one reads the world, all report.
    Returns each round's groups and the verdicts."""
    groups = []
    for reports in rounds:
        for rank in range(n):
            manager.join_rendezvous(rank, 1)
        worlds = {rank: manager.get_comm_world(rank)
                  for rank in range(n)}
        groups.append(sorted(sorted(w) for _, _, w in worlds.values()))
        for rank, (normal, elapsed) in reports.items():
            manager.report_network_status(rank, normal, elapsed)
    fault, count = manager.check_fault_node()
    return {"groups": groups, "fault": fault, "rounds": count,
            "stragglers": manager.detect_stragglers(),
            "success": manager.network_check_success()}


def _verdicts(n, rounds):
    j = _replay(JManager(JParams(n, n, 0.0)), n, rounds)
    t = _replay(TManager(TParams(n, n, 0.0)), n, rounds)
    return j, t


def test_two_node_gloo_launch_gives_two_rounds_and_jax_verdicts():
    master = JobMaster(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    master.prepare()
    reports = {0: [], 1: []}
    results = {}
    try:
        clients = [MasterClient(master.addr, node_id=r, node_rank=r)
                   for r in (0, 1)]
        for rank, client in enumerate(clients):
            report = client.report_network_status

            def recorded(normal, elapsed, rank=rank, report=report):
                reports[rank].append((normal, elapsed))
                return report(normal, elapsed)

            client.report_network_status = recorded

        def probe(rank):
            try:
                results[rank] = t_nc.run_network_check(
                    clients[rank], devices_per_node=1, timeout_s=120.0,
                    device="cpu")
            except Exception as exc:  # noqa: BLE001 - shown in the assert
                results[rank] = repr(exc)

        threads = [threading.Thread(target=probe, args=(r,))
                   for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert results == {0: True, 1: True}, results
        assert [len(reports[r]) for r in (0, 1)] == [2, 2]
        assert all(normal and elapsed > 0 for r in (0, 1)
                   for normal, elapsed in reports[r])
        mgr = master.rdzv_managers[RendezvousName.NETWORK_CHECK]
        port_fault = mgr.check_fault_node()
        port_stragglers = mgr.detect_stragglers()
        verdicts = [c.get_network_check_verdict() for c in clients]
        for c in clients:
            c.close()
    finally:
        master.stop()
    rounds = [{r: reports[r][i] for r in (0, 1)} for i in range(2)]
    j, t = _verdicts(2, rounds)
    assert t == j
    assert port_fault == (j["fault"], j["rounds"]) == ([], 2)
    assert port_stragglers == j["stragglers"]
    for rank, verdict in enumerate(verdicts):
        assert verdict.normal and verdict.is_straggler == (
            rank in j["stragglers"])


@pytest.mark.parametrize("n,rounds", [
    # node 3 fails both rounds: faulty
    (4, [{0: (True, 1.0), 1: (True, 1.1), 2: (True, 1.2), 3: (False, 0.0)},
         {0: (True, 1.0), 1: (True, 1.0), 2: (True, 1.3), 3: (False, 0.0)}]),
    # node 0 fails one round only: not faulty
    (2, [{0: (False, 0.0), 1: (True, 1.0)},
         {0: (True, 1.0), 1: (True, 1.0)}]),
    # node 3 over 2x the median in the latest round: a straggler
    (4, [{0: (True, 20.0), 1: (True, 21.0), 2: (True, 20.5),
          3: (True, 150.0)},
         {0: (True, 20.0), 1: (True, 21.0), 2: (True, 20.5),
          3: (True, 150.0)}]),
    # an odd world: the trailing node joins the last pair
    (3, [{0: (True, 1.0), 1: (False, 0.0), 2: (True, 9.0)},
         {0: (True, 1.0), 1: (False, 0.0), 2: (True, 1.0)}]),
])
def test_scripted_reports_give_the_jax_verdicts(n, rounds):
    j, t = _verdicts(n, rounds)
    assert t == j


def _no_probe_process(monkeypatch):
    """Rounds that pass at once, with no probe process."""
    class Probe:
        alive = True

        def __init__(self, device):
            pass

        def close(self):
            pass

    monkeypatch.setattr(t_nc, "_ProbeProcess", Probe)
    monkeypatch.setattr(t_nc, "_probe_round",
                        lambda *a, **k: (True, 1.0, 0))


def _fake_client(normal, is_straggler):
    class Client:
        node_rank = 0
        reports = []

        def report_network_status(self, ok, elapsed):
            self.reports.append((ok, elapsed))
            return True

        def get_network_check_verdict(self):
            return msg.NetworkCheckVerdict(
                normal=normal, is_straggler=is_straggler,
                reason="" if normal else "fault")

    return Client()


@pytest.mark.parametrize("normal,straggler,exclude", [
    (True, False, False), (True, True, False), (True, True, True),
    (False, False, False), (False, True, True)])
def test_driver_admits_as_the_jax_driver(normal, straggler, exclude,
                                         monkeypatch):
    _no_probe_process(monkeypatch)
    monkeypatch.setattr(j_nc, "_probe_round", lambda *a, **k: (True, 1.0))
    t_client, j_client = (_fake_client(normal, straggler),
                          _fake_client(normal, straggler))
    got = t_nc.run_network_check(t_client, exclude_straggler=exclude,
                                 device="cpu")
    want = j_nc.run_network_check(j_client, exclude_straggler=exclude)
    assert got == want == (normal and not (straggler and exclude))
    assert len(t_client.reports) == len(j_client.reports) == 2


@pytest.mark.parametrize("verdict,flags,code", [
    ((True, True), ["--exclude-straggler"], 3),
    ((False, False), [], 3),
    ((True, True), [], 0),
])
def test_run_exits_3_when_the_verdict_keeps_the_node_out(
        verdict, flags, code, tmp_path, monkeypatch):
    _no_probe_process(monkeypatch)
    monkeypatch.setattr(
        MasterClient, "get_network_check_verdict",
        lambda self: msg.NetworkCheckVerdict(
            normal=verdict[0], is_straggler=verdict[1]))
    out = tmp_path / "ran"
    script = tmp_path / "w.py"
    script.write_text(f"open({str(out)!r}, 'w').write('ran')\n")
    rc = t_run.main(["--standalone", "--monitor-interval", "0.1",
                     "--devices-per-node", "1", "--network-check",
                     "--device", "cpu", *flags, str(script)])
    assert rc == code
    assert out.exists() == (code == 0)


def test_standalone_launch_runs_the_probe_before_the_worker(tmp_path):
    """``python -m dlrover_tpu_torch.run --standalone --network-check
    --device cpu``: two normal rounds in the agent's log, then the
    worker runs."""
    out = tmp_path / "ran"
    script = tmp_path / "w.py"
    script.write_text(f"open({str(out)!r}, 'w').write('ran')\n")
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
         "--monitor-interval", "0.2", "--devices-per-node", "1",
         "--network-check", "--device", "cpu", str(script)],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    for i in (0, 1):
        assert f"network check round {i}: normal=True" in proc.stderr
    assert out.read_text() == "ran"
    assert proc.stderr.index("network check round 1") \
        < proc.stderr.index("spawning worker")


def test_one_probe_process_serves_both_rounds(monkeypatch):
    spawned = []
    real = t_nc._ProbeProcess

    class Counted(real):
        def __init__(self, device):
            spawned.append(device)
            super().__init__(device)

    monkeypatch.setattr(t_nc, "_ProbeProcess", Counted)
    master = JobMaster(port=0, min_nodes=1, max_nodes=1, host="127.0.0.1")
    master.prepare()
    try:
        client = MasterClient(master.addr, node_id=0, node_rank=0)
        assert t_nc.run_network_check(client, timeout_s=120.0, device="cpu")
        client.close()
    finally:
        master.stop()
    assert spawned == ["cpu"]


def test_a_failed_round_answers_and_the_process_serves_the_next(
        monkeypatch):
    """A round whose group cannot form fails (normal=False) without
    ending the probe process, which then serves a good round."""
    monkeypatch.setenv("DLROVER_TPU_DIST_INIT_TIMEOUT", "2")
    probe = t_nc._ProbeProcess("cpu")
    try:
        # rank 1 of a pair whose rank 0 never listens
        assert probe.run(2, 1, "127.0.0.1:9", timeout_s=120.0) \
            == (False, 0.0)
        assert probe.alive
        normal, elapsed = probe.run(1, 0, "127.0.0.1:9", timeout_s=120.0)
        assert normal and elapsed > 0
    finally:
        probe.close()
    assert not probe.alive
