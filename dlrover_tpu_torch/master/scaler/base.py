"""ScalePlan model + Scaler interface.

Own copy of the JAX package's ``master/scaler/base.py``, after
dlrover/python/master/scaler/base_scaler.py: a plan names the target
group sizes plus explicit node launches and removals; a Scaler actuates
it against the platform.
"""

from __future__ import annotations

import abc
import threading
from dataclasses import dataclass, field
from typing import Dict, List

from dlrover_tpu_torch.common.node import Node, NodeGroupResource


@dataclass
class ScalePlan:
    # Target per-type group size/resource ("scale to N workers of shape R").
    node_group_resources: Dict[str, NodeGroupResource] = field(
        default_factory=dict)
    # Explicit node launches (relaunches carry rank/config of the dead node).
    launch_nodes: List[Node] = field(default_factory=list)
    # Explicit removals.
    remove_nodes: List[Node] = field(default_factory=list)

    def empty(self) -> bool:
        return (not self.node_group_resources and not self.launch_nodes
                and not self.remove_nodes)

    def merge(self, other: "ScalePlan") -> None:
        self.node_group_resources.update(other.node_group_resources)
        self.launch_nodes.extend(other.launch_nodes)
        self.remove_nodes.extend(other.remove_nodes)


class Scaler(abc.ABC):
    """Actuates ScalePlans (reference: Scaler base, pod_scaler.py:71)."""

    def __init__(self, job_name: str):
        self.job_name = job_name
        self._id_lock = threading.Lock()
        self._next_id: Dict[str, int] = {}

    @abc.abstractmethod
    def scale(self, plan: ScalePlan) -> None:
        ...

    def start(self) -> None:  # pragma: no cover - default no-op
        pass

    def stop(self) -> None:  # pragma: no cover - default no-op
        pass

    # -- node-id allocation (shared by all backends) --------------------
    def alloc_id(self, node_type: str) -> int:
        with self._id_lock:
            next_id = self._next_id.get(node_type, 0)
            self._next_id[node_type] = next_id + 1
            return next_id

    def register_existing(self, node_type: str, upto_id: int) -> None:
        """Keep the allocator ahead of externally-assigned ids (manager
        relaunch ids) so a group-grow never reuses a live pod name."""
        with self._id_lock:
            self._next_id[node_type] = max(
                self._next_id.get(node_type, 0), upto_id)

    @staticmethod
    def fill_rank_holes(used_ranks, count: int, needed: int) -> List[int]:
        """Ranks for `needed` new nodes: lowest free ranks below `count`
        first (a relaunched node keeps its rank, so grows must fill the
        holes), then sequential past the end."""
        used = set(used_ranks)
        free = [r for r in range(count) if r not in used]
        ranks = free[:needed]
        rank = count
        while len(ranks) < needed:
            if rank not in used:
                ranks.append(rank)
            rank += 1
        return ranks
