"""Process-set bootstrap through the master's KV store.

Own copy of the JAX package's ``common/bootstrap.py``: the rank-0 member
of a rendezvous world publishes the process group's rendezvous address
(``host:port``, the ``tcp://`` init method of ``torch.distributed``)
through the master KV store; everyone else blocks on the key.
"""

from __future__ import annotations

from dlrover_tpu_torch.common.comm import find_free_port, local_ip


def publish_or_wait_coordinator(client, key: str, process_id: int,
                                timeout_s: float) -> str:
    """Rank 0 publishes `ip:port` under `key`; others wait for it."""
    if process_id == 0:
        coord = f"{local_ip()}:{find_free_port()}"
        client.kv_set(key, coord.encode())
        return coord
    return client.kv_wait(key, timeout_s=timeout_s).decode()
