"""The port's mesh (dlrover_tpu_torch.parallel.mesh), its constants and
the worker's side of the agent contract, against the JAX package.

Multi-process cases run gloo process groups: ``run_workers`` (imported by
the other ``test_torch_*`` files) writes a worker script into
``tmp_path`` that imports only torch and the port, and starts one
process per rank under the agent's environment contract
(``DLROVER_TPU_WORLD_SIZE``, ``DLROVER_TPU_PROCESS_ID``,
``DLROVER_TPU_COORDINATOR``) on a free localhost port, with a timeout of
its own. Each worker prints one JSON line last; the launcher returns
them in rank order. A launch whose port another process took before
rank 0 bound it (EADDRINUSE) is run again on a new port.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from dlrover_tpu.common import constants as jconst
from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.common import constants as tconst
from dlrover_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


# launches of one run_workers call: another process may take the free
# port between _free_port() and rank 0's bind (EADDRINUSE); the whole
# launch is then retried on a new port
PORT_ATTEMPTS = 3


def _port_taken(stderr: str) -> bool:
    return "EADDRINUSE" in stderr or "ddress already in use" in stderr


def run_workers(tmp_path, source: str, world: int, args=(),
                timeout: float = WORKER_TIMEOUT_S, name: str = "worker"):
    """Run ``source`` as ``world`` gloo ranks; return each rank's last
    stdout line parsed as JSON. A rank that fails or outlives the timeout
    fails the test with its stderr; a launch whose coordinator port was
    taken before rank 0 bound it is retried on another port."""
    script = tmp_path / f"{name}.py"
    script.write_text(textwrap.dedent(source))
    for attempt in range(PORT_ATTEMPTS):
        results = _launch(script, tmp_path, world, args, timeout, name,
                          retry=attempt + 1 < PORT_ATTEMPTS)
        if results is not None:
            return results
    raise AssertionError("unreachable: the last attempt fails the test")


def _launch(script, tmp_path, world, args, timeout, name, retry):
    """One launch on a fresh port: each rank's JSON, or None when the
    port was taken and ``retry`` allows another launch."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   DLROVER_TPU_WORLD_SIZE=str(world),
                   DLROVER_TPU_PROCESS_ID=str(rank),
                   DLROVER_TPU_COORDINATOR=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *map(str, args)], env=env,
            cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    results = []
    try:
        for rank, proc in enumerate(procs):
            try:
                out, err = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{name} rank {rank} outlived {timeout} s")
            if proc.returncode:
                if retry and _port_taken(err):
                    return None
                pytest.fail(f"{name} rank {rank} exited {proc.returncode}:"
                            f"\n{err[-6000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def test_constants_copy_matches_jax_package():
    for name in ("DCN", "DATA", "FSDP", "TENSOR", "SEQUENCE", "EXPERT",
                 "PIPE", "ALL"):
        assert getattr(tconst.MeshAxis, name) == getattr(jconst.MeshAxis,
                                                         name)
    for name in ("NODE_RANK", "WORLD_SIZE", "PROCESS_ID",
                 "COORDINATOR_ADDR"):
        assert getattr(tconst.NodeEnv, name) == getattr(jconst.NodeEnv, name)
    assert (tconst.EMERGENCY_CKPT_MIN_WINDOW_S
            == jconst.DefaultValues.EMERGENCY_CKPT_MIN_WINDOW_S)


SPECS = [
    (dict(), 8), (dict(tensor=2), 8), (dict(fsdp=2, tensor=2), 8),
    (dict(data=2, fsdp=2, tensor=2), 8), (dict(dcn=2, fsdp=2), 8),
    (dict(data=2, tensor=2), 4), (dict(fsdp=2), 2), (dict(pipe=2), 4),
    (dict(sequence=2, expert=2), 8), (dict(tensor=4), 4), (dict(), 1),
]


@pytest.mark.parametrize("kw,n", SPECS)
def test_mesh_spec_matches_jax(kw, n):
    j = jmesh.MeshSpec(**kw).with_total_devices(n)
    t = tmesh.MeshSpec(**kw).with_total_devices(n)
    assert t.axis_sizes() == j.axis_sizes()
    assert t.total == j.total == n
    assert dataclass_fields(t) == dataclass_fields(j)


def dataclass_fields(spec):
    return {f: getattr(spec, f) for f in ("data", "fsdp", "tensor",
                                          "sequence", "expert", "pipe",
                                          "dcn")}


@pytest.mark.parametrize("kw,n", [(dict(data=3), 4), (dict(tensor=3), 8),
                                  (dict(fsdp=2, data=2), 8)])
def test_mesh_spec_errors_match_jax(kw, n):
    for spec in (jmesh.MeshSpec(**kw), tmesh.MeshSpec(**kw)):
        with pytest.raises(ValueError):
            spec.with_total_devices(n)


def test_from_pairs_matches_jax():
    pairs = [("data", 2), ("tensor", 2), ("data", 2), ("fsdp", 2)]
    assert (dataclass_fields(tmesh.MeshSpec.from_pairs(pairs))
            == dataclass_fields(jmesh.MeshSpec.from_pairs(pairs)))
    for cls in (jmesh.MeshSpec, tmesh.MeshSpec):
        with pytest.raises(ValueError, match="unknown mesh axis"):
            cls.from_pairs([("model", 2)])


@pytest.mark.parametrize("kw,n", [s for s in SPECS if s[1] > 1])
def test_rank_order_matches_jax_device_order(cpu_devices, kw, n):
    """Row-major over (dcn, data, fsdp, pipe, expert, sequence, tensor):
    the rank at each coordinate is the JAX mesh's CPU device id there."""
    jax_mesh = jmesh.create_mesh(jmesh.MeshSpec(**kw), cpu_devices[:n])
    want = np.vectorize(lambda d: d.id)(jax_mesh.devices)
    got = tmesh.rank_grid(tmesh.MeshSpec(**kw).with_total_devices(n))
    assert got.tolist() == want.tolist()
    assert tuple(jax_mesh.axis_names) == tconst.MeshAxis.ALL[:3] + (
        "pipe", "expert", "sequence", "tensor")


@pytest.mark.parametrize("kw,n", [s for s in SPECS if s[1] > 1])
def test_data_axes_and_sizes_match_jax(cpu_devices, kw, n):
    jax_mesh = jmesh.create_mesh(jmesh.MeshSpec(**kw), cpu_devices[:n])
    mesh = tmesh.Mesh(tmesh.MeshSpec(**kw).with_total_devices(n),
                      torch.device("cpu"))
    assert mesh.shape == dict(jax_mesh.shape)
    assert tmesh.data_axes(mesh) == jmesh.data_axes(jax_mesh)
    assert tmesh.dp_size(mesh) == jmesh.dp_size(jax_mesh)
    assert tmesh.dcn_size(mesh) == jmesh.dcn_size(jax_mesh)


def test_single_process_mesh_needs_no_group(monkeypatch):
    monkeypatch.setenv(tconst.NodeEnv.WORLD_SIZE, "1")
    init_distributed("cpu")
    assert not torch.distributed.is_initialized()
    mesh = tmesh.create_mesh(device="cpu")
    assert mesh.device_mesh is None and mesh.device == torch.device("cpu")
    assert set(mesh.shape.values()) == {1}
    assert tmesh.dp_index(mesh) == 0 and tmesh.dp_size(mesh) == 1


MESH_WORKER = """
import json
import torch
import torch.distributed as dist
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.parallel import mesh

init_distributed("cpu")
m = mesh.create_mesh(mesh.MeshSpec(tensor=2), "cpu")
print(json.dumps({
    "backend": dist.get_backend(), "rank": dist.get_rank(),
    "grid": m.device_mesh.mesh.tolist(),
    "want": mesh.rank_grid(m.spec).tolist(),
    "coordinate": m.coordinate(), "dp_index": mesh.dp_index(m),
    "dp_ranks": m.submesh(mesh.data_axes(m)).mesh.tolist(),
}))
"""


def test_gloo_mesh_lays_ranks_row_major(tmp_path):
    out = run_workers(tmp_path, MESH_WORKER, 4)
    for rank, r in enumerate(out):
        assert r["backend"] == "gloo" and r["rank"] == rank
        assert r["grid"] == r["want"]
        assert r["coordinate"]["data"] == rank // 2
        assert r["coordinate"]["tensor"] == rank % 2
        assert r["dp_index"] == rank // 2
        # the data-parallel group: the ranks of this tensor coordinate
        assert r["dp_ranks"] == [rank % 2, rank % 2 + 2]
