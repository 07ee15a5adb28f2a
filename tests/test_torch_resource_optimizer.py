"""The port's resource optimizer, auto-scaler and stats collection
against the JAX package's (tests/test_resource_optimizer.py's cases): the
same runtime samples give the same plans (as dataclass dicts) in both
packages, the auto-scaler grows the same job manager the same way, its
tuned knobs reach the servicer's ParallelConfig alike, and the job
collector reports the same records. The brain's reporter and optimizer
are refused by name."""

import dataclasses
import time

import pytest

from dlrover_tpu.master.node import job_auto_scaler as jscaler
from dlrover_tpu.master.resource import local_optimizer as jopt
from dlrover_tpu.master.resource import optimizer as jbase
from dlrover_tpu.master.resource import stats_collector as jstats
from dlrover_tpu.master.servicer import MasterServicer as JServicer
from dlrover_tpu.master.stats import job_collector as jcollect
from dlrover_tpu.master.stats import reporter as jreport
from dlrover_tpu_torch.master.job_master import JobMaster
from dlrover_tpu_torch.master.node import job_auto_scaler as tscaler
from dlrover_tpu_torch.master.resource import local_optimizer as topt
from dlrover_tpu_torch.master.resource import optimizer as tbase
from dlrover_tpu_torch.master.resource import stats_collector as tstats
from dlrover_tpu_torch.master.servicer import MasterServicer as TServicer
from dlrover_tpu_torch.master.stats import job_collector as tcollect
from dlrover_tpu_torch.master.stats import reporter as treport
from test_torch_job_manager import JAX, PORT, make_job_args, start_manager
from test_torch_job_manager import wait_until

OPT = {"jax": (jopt, jbase, jstats), "port": (topt, tbase, tstats)}


def _sample(stats_mod, cpu=50.0, mem=4096.0, duty=80.0):
    return stats_mod.NodeSample(timestamp=time.time(), cpu_percent=cpu,
                                memory_mb=mem, chip_duty_cycle_pct=duty)


def _create(pkg):
    opt, base, _ = pkg
    return [opt.LocalResourceOptimizer().generate_plan(
        base.OptimizeStage.JOB_CREATE, {"worker_count": 4, "chips": 8})]


def _initial(pkg):
    opt, base, stats_mod = pkg
    stats = stats_mod.RuntimeStatsCollector()
    stats.add_node_sample("worker", 0, _sample(stats_mod, mem=10000))
    stats.add_node_sample("worker", 1, _sample(stats_mod, mem=12000))
    return [opt.LocalResourceOptimizer(stats).generate_plan(
        base.OptimizeStage.NODE_INITIAL, {})]


def _grow(pkg):
    opt, base, stats_mod = pkg
    stats = stats_mod.RuntimeStatsCollector()
    stats.add_speed_sample(2, 10.0)
    return [opt.LocalResourceOptimizer(stats).generate_plan(
        base.OptimizeStage.RUNNING,
        {"worker_count": 2, "max_worker_count": 4})]


def _efficiency(pkg):
    opt, base, stats_mod = pkg
    stats = stats_mod.RuntimeStatsCollector()
    for _ in range(3):
        stats.add_speed_sample(2, 10.0)
        stats.add_speed_sample(3, 10.4)  # barely faster: don't grow
    return [opt.LocalResourceOptimizer(stats).generate_plan(
        base.OptimizeStage.RUNNING,
        {"worker_count": 2, "max_worker_count": 4})]


def _zero_speed(pkg):
    opt, base, stats_mod = pkg
    stats = stats_mod.RuntimeStatsCollector()
    stats.add_speed_sample(8, 0.0)
    return [opt.LocalResourceOptimizer(stats).generate_plan(
        base.OptimizeStage.RUNNING,
        {"worker_count": 8, "max_worker_count": 16})]


def _shrink_back(pkg):
    opt, base, stats_mod = pkg
    stats = stats_mod.RuntimeStatsCollector()
    stats.add_speed_sample(2, 10.0)
    stats.add_speed_sample(3, 10.2)  # growth didn't pay off
    optimizer = opt.LocalResourceOptimizer(stats)
    return [optimizer.generate_plan(base.OptimizeStage.RUNNING,
                                    {"worker_count": count,
                                     "max_worker_count": 4})
            for count in (3, 2)]


def _hot_host(pkg):
    opt, base, stats_mod = pkg
    stats = stats_mod.RuntimeStatsCollector()
    stats.add_node_sample("worker", 0,
                          _sample(stats_mod, cpu=95.0, duty=20.0))
    stats.add_speed_sample(1, 5.0)
    return [opt.LocalResourceOptimizer(stats).generate_plan(
        base.OptimizeStage.RUNNING,
        {"worker_count": 1, "max_worker_count": 1})]


def _oom(pkg):
    opt, _, _ = pkg
    return [opt.LocalResourceOptimizer().generate_oom_recovery_plan(
        "worker", 8192)]


def _limits(pkg):
    opt, base, _ = pkg
    plan = opt.LocalResourceOptimizer().generate_plan(
        base.OptimizeStage.JOB_CREATE,
        {"worker_count": 100, "memory_mb": 999999})
    return [plan.limit(base.ResourceLimits(max_nodes=8,
                                           max_memory_mb=32768))]


def _scale_unit(pkg):
    opt, base, stats_mod = pkg
    stats = stats_mod.RuntimeStatsCollector()
    stats.add_speed_sample(4, 10.0)
    stats.add_speed_sample(6, 16.0)
    return [opt.LocalResourceOptimizer(stats, scale_unit=2).generate_plan(
        base.OptimizeStage.RUNNING,
        {"worker_count": 4, "max_worker_count": 8})]


CASES = {f.__name__[1:]: f for f in (
    _create, _initial, _grow, _efficiency, _zero_speed, _shrink_back,
    _hot_host, _oom, _limits, _scale_unit)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plans_match_jax(case):
    want, got = ([dataclasses.asdict(plan) for plan in CASES[case](pkg)]
                 for pkg in (OPT["jax"], OPT["port"]))
    assert got == want


def test_plans_reach_their_ends():
    """What the cases reach (the parity test holds the port to JAX)."""
    pkg = OPT["port"]
    assert _grow(pkg)[0].node_group_resources["worker"].count == 3
    assert _efficiency(pkg)[0].empty() and _zero_speed(pkg)[0].empty()
    first, second = _shrink_back(pkg)
    assert first.node_group_resources["worker"].count == 2
    assert second.empty()
    assert _hot_host(pkg)[0].dataloader_workers == 2
    resource = _initial(pkg)[0].node_group_resources["worker"].node_resource
    assert resource.memory_mb == 12000 * 1.4


def _auto_scale(pkg, scaler_mod, opt_mod, stats_mod):
    cluster, manager = start_manager(pkg, workers=2)
    try:
        manager.job_args.worker_args().max_count = 4
        stats = stats_mod.RuntimeStatsCollector()
        stats.add_speed_sample(2, 10.0)
        scaler = scaler_mod.JobAutoScaler(
            manager, opt_mod.LocalResourceOptimizer(stats),
            speed_monitor=pkg.SpeedMonitor(), interval_s=3600)
        plan = scaler.execute_job_optimization()
        assert wait_until(lambda: len(manager.get_running_workers()) == 3)
        return (dataclasses.asdict(plan),
                sorted(n.rank_index for n in manager.get_running_workers()),
                manager.job_args.worker_args().group_resource.count)
    finally:
        manager.stop()


def test_auto_scaler_grows_the_job_as_jax():
    want = _auto_scale(JAX, jscaler, jopt, jstats)
    got = _auto_scale(PORT, tscaler, topt, tstats)
    assert got == want
    assert got[1:] == ([0, 1, 2], 3)


def _paral_sink(pkg, scaler_mod, opt_mod, stats_mod, servicer_cls):
    cluster, manager = start_manager(pkg, workers=1)
    try:
        stats = stats_mod.RuntimeStatsCollector()
        stats.add_node_sample("worker", 0,
                              _sample(stats_mod, cpu=95.0, duty=20.0))
        servicer = servicer_cls()
        scaler = scaler_mod.JobAutoScaler(
            manager, opt_mod.LocalResourceOptimizer(stats),
            speed_monitor=pkg.SpeedMonitor(), interval_s=3600)
        scaler.paral_config_sink = servicer.merge_paral_config
        # pre-existing tuned fields survive the hot-host merge
        servicer.update_paral_config(
            pkg.msg.ParallelConfig(dataloader_batch_size=64, version=5))
        scaler.execute_job_optimization()
        scaler.execute_job_optimization()     # same knobs: no new version
        config = servicer.get(pkg.msg.ParallelConfigRequest())
        return (dataclasses.asdict(config), scaler.paral_config_version,
                scaler.suggested_dataloader_workers)
    finally:
        manager.stop()


def test_tuned_knobs_reach_the_servicer_as_jax():
    want = _paral_sink(JAX, jscaler, jopt, jstats, JServicer)
    got = _paral_sink(PORT, tscaler, topt, tstats, TServicer)
    assert got == want
    assert got[0]["dataloader_workers"] == 2
    assert got[0]["dataloader_batch_size"] == 64
    assert got[0]["version"] == 6


def _collect(pkg, collect_mod, report_mod, path):
    reporter = report_mod.LocalStatsReporter(path=str(path))
    collector = collect_mod.JobMetricCollector("j", reporter)
    for duty in (95, -1.0):
        collector.collect_node_stats(pkg.msg.NodeResourceStats(
            node_id=0, node_type="worker", cpu_percent=80, memory_mb=2048,
            chip_stats=[pkg.msg.ChipStats(index=0, duty_cycle_pct=duty,
                                          hbm_used_mb=30000)]))
    collector.collect_model_info(pkg.msg.ModelInfo(param_count=100))
    collector.collect_model_info(pkg.msg.ModelInfo(param_count=100))
    collector.report_job_meta(worker_count=2, cpu=4)
    collector.report_job_exit("succeeded", "done")
    records = [{k: v for k, v in r.items() if k != "ts"}
               for r in reporter.records()]
    sample = collector.stats.latest_node_sample("worker", 0)
    return (records, collector._runtime_payload(),
            dataclasses.asdict(sample) | {"timestamp": 0},
            len(path.read_text().splitlines()))


def test_job_collector_reports_as_jax(tmp_path):
    want = _collect(JAX, jcollect, jreport, tmp_path / "jax.jsonl")
    got = _collect(PORT, tcollect, treport, tmp_path / "port.jsonl")
    assert got == want
    records = got[0]
    assert [r["type"] for r in records] == ["model", "job_meta",
                                            "job_exit"]   # model deduped
    assert got[2]["chip_duty_cycle_pct"] == -1.0


def test_brain_is_refused_by_name():
    """The brain is ported (it was refused by name before): the brain
    reporter is built, and a cluster-mode master with a brain address
    attaches the brain's optimizer."""
    from dlrover_tpu_torch.brain.client import (
        BrainReporter,
        BrainResourceOptimizer,
    )

    reporter = treport.StatsReporter.new_reporter(
        treport.ReporterType.BRAIN, addr="127.0.0.1:1", job_name="j")
    assert isinstance(reporter, BrainReporter)
    args = make_job_args(1)
    args.optimize_mode = "cluster"
    master = JobMaster(port=0, host="127.0.0.1", job_args=args,
                       brain_addr="127.0.0.1:1")
    try:
        assert isinstance(master.auto_scaler._optimizer,
                          BrainResourceOptimizer)
    finally:
        master.stop(grace_s=0.1)


def test_master_attaches_the_optimization_as_jax():
    """A job-managed master has its collector (with the job's meta
    reported), and an auto-scaler whose sink is the servicer's merge,
    unless the optimize mode is manual."""
    master = JobMaster(port=0, host="127.0.0.1", job_args=make_job_args(2))
    try:
        records = master.metric_collector._reporter.records("job_meta")
        assert records[0]["worker_count"] == 2
        assert records[0]["chip_type"] == "h100"
        assert master.auto_scaler.paral_config_sink == \
            master.servicer.merge_paral_config
        assert master.servicer.metric_collector is master.metric_collector
    finally:
        master.stop(grace_s=0.1)
    args = make_job_args(1)
    args.optimize_mode = "manual"
    master = JobMaster(port=0, host="127.0.0.1", job_args=args)
    try:
        assert master.auto_scaler is None
        assert master.metric_collector is not None
    finally:
        master.stop(grace_s=0.1)
    exits = [r for r in master.metric_collector._reporter.records()
             if r["type"] == "job_exit"]
    assert exits and exits[0]["stage"] == "created"
