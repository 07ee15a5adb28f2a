"""Elastic embedding training: the parameter-server path without servers.

Counterpart of ``dlrover_tpu/trainer/embedding.py``, after the reference's
TF/PS elastic training (EstimatorExecutor trainer/tensorflow/executor/
estimator_executor.py:52, PS failover tensorflow_failover.py:33,
ElasticPsService cluster-version arbitration master/elastic_training/
elastic_ps.py:18). There are no parameter-server processes: the
embedding table is one tensor whose rows shard over the mesh's ``fsdp``
axis (a DTensor ``Shard(0)`` by ``EMBEDDING_RULES``), updated row-sparsely
(``optim/sparse.py``), and "PS failover" is cluster-version arbitration
through the master's ``ElasticPsService`` plus a restore of the table
from the latest committed flash checkpoint.

The lookup is ``F.embedding`` on this rank's rows; with the table
sharded, every rank looks up the ids its rows hold and the shards' parts
are summed across the group (identity in the backward: the batch and the
dense tower are replicated, as the JAX step computes them), so each
rank's table gradient lands in its own rows only. As in the JAX package
the batch is replicated over the mesh, and the dense tower is an
ordinary module every rank updates alike.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from dlrover_tpu_torch.common.constants import MeshAxis
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.optim.base import LeafOptimizer, LeafTransform
from dlrover_tpu_torch.optim.sparse import row_sparse_adagrad
from dlrover_tpu_torch.parallel.sharding import (
    local_slice,
    mesh_placements,
    sharded_from_host,
    to_local,
)
from dlrover_tpu_torch.trainer.train_step import _init_optimizer_state


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    vocab_size: int
    embed_dim: int
    combiner: str = "none"      # "none" | "mean" | "sum" (multi-hot bags)
    param_dtype: torch.dtype = torch.float32


# logical-axis rules for the PS path: rows over fsdp (the "server shard"
# dim), columns replicated
EMBEDDING_RULES = [
    ("embed_rows", MeshAxis.FSDP),
    ("embed_cols", None),
]


class _SumShards(torch.autograd.Function):
    """The shards' partial lookups summed over the row group; the
    gradient passes through unchanged (every rank computes the same
    loss from the summed rows)."""

    @staticmethod
    def forward(ctx, partial: torch.Tensor, group) -> torch.Tensor:
        total = partial.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class ShardedEmbedding(nn.Module):
    """Embedding table (vocab × dim, normal(0.01)) whose rows shard over
    the fsdp axis (the PS shard dimension) once ``shard`` is called."""

    def __init__(self, cfg: EmbeddingConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.combiner not in ("none", "mean", "sum"):
            raise ValueError(f"unknown combiner {cfg.combiner!r}")
        self.cfg = cfg
        device = resolve_device(device)
        table = torch.empty(cfg.vocab_size, cfg.embed_dim,
                            dtype=cfg.param_dtype, device=device)
        with torch.no_grad():
            table.normal_(0.0, 0.01, generator=generator)
        self.table = nn.Parameter(table)
        self.param_axes = {"table": ("embed_rows", "embed_cols")}
        # this rank's first row and the group its rows are summed over,
        # once the table is sharded
        self._first_row = 0
        self._group = None

    def shard(self, mesh) -> "ShardedEmbedding":
        """Lay the table out over ``mesh`` by ``EMBEDDING_RULES`` (a mesh
        of one process, or a size-1 fsdp axis, leaves it whole). The rows
        shard over the 1-D mesh of the axes the rules give them: DTensor's
        sharding propagation over all seven mesh axes costs far more than
        the table's elementwise update."""
        placements = mesh_placements(self, mesh, EMBEDDING_RULES)["table"]
        axes = [axis for axis, p in zip(mesh.axis_names, placements)
                if isinstance(p, Shard) and mesh.shape[axis] > 1]
        if mesh.device_mesh is None or not axes:
            return self
        rows_mesh = mesh.submesh(axes)
        self.table = nn.Parameter(distribute_tensor(
            self.table.detach(), rows_mesh, [Shard(0)]))
        rows = local_slice(self.table.shape, rows_mesh, [Shard(0)])[0]
        self._first_row = rows.start
        self._group = rows_mesh.get_group()
        return self

    def forward(self, ids) -> torch.Tensor:
        table = self.table
        local = to_local(table)
        ids = torch.as_tensor(ids, device=local.device).long()
        if isinstance(table, DTensor):
            first = self._first_row
            hit = (ids >= first) & (ids < first + local.shape[0])
            out = F.embedding(torch.where(hit, ids - first, 0), local)
            out = _SumShards.apply(out * hit.unsqueeze(-1).to(out.dtype),
                                   self._group)
        else:
            out = F.embedding(ids, local)
        if self.cfg.combiner in ("mean", "sum") and ids.dim() >= 2:
            # bag lookup: (..., multi_hot, dim) → (..., dim)
            out = (out.mean(dim=-2) if self.cfg.combiner == "mean"
                   else out.sum(dim=-2))
        return out


class EmbeddingModel(nn.Module):
    """The sparse table and the dense tower on top of it."""

    def __init__(self, embedding: ShardedEmbedding, dense: nn.Module):
        super().__init__()
        self.embedding = embedding
        self.dense = dense

    def forward(self, ids) -> torch.Tensor:
        return self.dense(self.embedding(ids))


@dataclasses.dataclass
class EmbeddingTrainState:
    """The JAX tuple (embed params, embed opt, dense params, dense opt):
    the parameters live in ``model``, the two optimizers' states in
    ``optimizer`` (the table's first). ``FlashCheckpointer`` saves and
    restores it as it does a ``TrainState``."""

    step: int
    model: EmbeddingModel
    optimizer: List[torch.optim.Optimizer]


@dataclasses.dataclass
class ReconcileResult:
    """Outcome of ``ElasticEmbeddingTrainer.maybe_reconcile``: the
    (possibly restored) state, whether a restore happened, and the
    checkpoint's step and data position; the caller rolls its sampler
    back with the parameters."""

    state: Any
    reconciled: bool
    step: int = 0
    data_state: Any = None


class EmbeddingFailoverClient:
    """Worker-side cluster-version arbitration.

    After FailoverClient (trainer/tensorflow/failover/failover_client.py:
    21) + TensorflowFailover (:91-144): the worker adopts the global
    version at start, publishes it as its local version, and watches for
    the global version to advance past it; the master's
    PsFailoverCallback bumps it when a state holder dies. A lagging local
    version means this worker's view of the sharded state is stale and
    it must reconcile (restore from the latest committed checkpoint)
    before training on.
    """

    def __init__(self, master_client, task_type: str = "worker"):
        self._client = master_client
        self._task_type = task_type
        self.local_version = 0

    def start(self) -> int:
        """Adopt the current global version and publish it as local."""
        self.local_version = self._client.get_cluster_version(
            "global", self._task_type)
        self._client.update_cluster_version(
            "local", self.local_version, self._task_type)
        return self.local_version

    def needs_reconcile(self) -> bool:
        return (self._client.get_cluster_version("global", self._task_type)
                > self.local_version)

    def complete_reconcile(self) -> int:
        """Adopt the (possibly again-advanced) global version after a
        successful restore and publish it."""
        self.local_version = self._client.get_cluster_version(
            "global", self._task_type)
        self._client.update_cluster_version(
            "local", self.local_version, self._task_type)
        return self.local_version

    def wait_reconciled_cluster(self, task_ids, timeout_s: float = 60.0
                                ) -> bool:
        """Block until every LIVE worker's published local version has
        caught up with the global version (the reference's sync barrier
        around PS migration). ``task_ids`` is the live membership, taken
        from the current world, NOT a count: relaunched nodes get fresh
        ids, so positional ranges would poll the dead."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            global_v = self._client.get_cluster_version(
                "global", self._task_type)
            locals_ok = all(
                self._client.get_cluster_version(
                    "local", self._task_type, task_id=i) >= global_v
                for i in task_ids)
            if locals_ok:
                return True
            time.sleep(0.1)
        return False


def _adam(params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """optax.adam(1e-3): torch's Adam divides by sqrt(ν̂) + eps, optax's
    placement of eps (eps_root 0)."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


class ElasticEmbeddingTrainer:
    """PS-style training core: sparse embedding + dense tower.

    Version arbitration contract (reference elastic_ps.py): workers call
    ``client.update_cluster_version("local", v)`` after restoring and
    train only once ``get_cluster_version("global") >= local``; the
    master's ElasticPsService (master/sync_service.py) decides the
    global version.

    ``embed_tx`` is the table's per-leaf transform (row-sparse Adagrad at
    0.05 by default), ``dense_tx`` builds the dense tower's optimizer
    from its parameters (Adam at 1e-3 by default): the reference's
    sparse-PS / dense-worker split.
    """

    def __init__(
        self,
        mesh,
        embedding: ShardedEmbedding,
        dense: nn.Module,
        loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        embed_tx: Optional[LeafTransform] = None,
        dense_tx: Optional[Callable[[Iterable[torch.Tensor]],
                                    torch.optim.Optimizer]] = None,
    ):
        self.mesh = mesh
        self.embedding = embedding
        self.dense = dense
        self.loss_fn = loss_fn
        self.embed_tx = embed_tx or row_sparse_adagrad(0.05)
        self.dense_tx = dense_tx or _adam

    def init(self) -> EmbeddingTrainState:
        """Shard the table over the mesh and build both optimizers' state
        (the dense one's too, so a checkpoint restores into it before any
        step)."""
        self.embedding.shard(self.mesh)
        model = EmbeddingModel(self.embedding, self.dense)
        embed_opt = LeafOptimizer([self.embedding.table], self.embed_tx)
        dense_opt = self.dense_tx(self.dense.parameters())
        # Adam's state made now (optax's init: zero moments, count 0),
        # not at its first step
        _init_optimizer_state(dense_opt)
        with torch.no_grad():
            for state in dense_opt.state.values():
                for value in state.values():
                    if torch.is_tensor(value) and value.dim():
                        value.zero_()
        return EmbeddingTrainState(step=0, model=model,
                                   optimizer=[embed_opt, dense_opt])

    def build_step(self) -> Callable[..., torch.Tensor]:
        """``step(state, ids, labels) -> loss``: one update of both
        optimizers in place (``state.step`` counts it)."""
        loss_fn = self.loss_fn

        def step(state: EmbeddingTrainState, ids, labels) -> torch.Tensor:
            model = state.model
            device = to_local(model.embedding.table).device
            labels = torch.as_tensor(labels, device=device)
            loss = loss_fn(model(ids), labels)
            loss.backward()
            for opt in state.optimizer:
                opt.step()
                # the table's gradient is as large as the table: free it
                opt.zero_grad(set_to_none=True)
            state.step += 1
            return loss.detach()

        return step

    @staticmethod
    def load_state(state: EmbeddingTrainState, params, opt_state) -> None:
        """Copy full values (``convert.embedding_state_from_jax``'s: the
        parameters by ``state.model``'s names, each one's optimizer state
        by name) into the live state, each to its own device, dtype and
        placement."""
        named = dict(state.model.named_parameters())
        names = {id(p): n for n, p in named.items()}
        with torch.no_grad():
            sharded_from_host(params, named, in_place=True)
            for opt in state.optimizer:
                for group in opt.param_groups:
                    for p in group["params"]:
                        sharded_from_host(opt_state[names[id(p)]],
                                          opt.state[p], in_place=True)
        if to_local(state.model.embedding.table).is_cuda:
            torch.cuda.synchronize()

    def maybe_reconcile(self, failover: EmbeddingFailoverClient,
                        checkpointer, state: EmbeddingTrainState
                        ) -> ReconcileResult:
        """The failover workflow the reference drives from
        tensorflow_failover.py:91-144: when the global cluster version
        advanced past this worker's local version (a state holder died),
        restore (embed params, embed opt, dense params, dense opt) from
        the latest committed checkpoint into the live state and its
        placements, adopt the version, and publish it.

        Call between steps; training must not proceed on a stale view
        once ``needs_reconcile()`` is true. The result carries the
        checkpoint's step and data state so the caller rolls its sampler
        back with the parameters (``state.step`` is rolled back). With no
        committed checkpoint NOTHING is published (the worker stays
        marked stale) and ``reconciled`` is False: the caller should keep
        retrying or escalate.
        """
        if not failover.needs_reconcile():
            return ReconcileResult(state=state, reconciled=False)
        restored = checkpointer.restore(state)
        if restored is None:
            logger.warning(
                "reconcile needed (global version ahead) but no committed "
                "checkpoint exists; staying stale")
            return ReconcileResult(state=state, reconciled=False)
        state, data_state, step = restored
        failover.complete_reconcile()
        return ReconcileResult(state=state, reconciled=True, step=step,
                               data_state=data_state)
