"""The input pipeline, counterpart of ``dlrover_tpu/data``:
``prefetch.py`` (device prefetch over a side CUDA stream and its
data-wait-driven depth tuner), ``shm_ring.py`` (the shared-memory ring a
coworker process pushes batches through) and ``coworker.py`` (the
cross-host coworker service). Nothing is imported here: a coworker that
imports ``shm_ring`` must not pay for torch."""
