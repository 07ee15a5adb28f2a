"""PyTorch and CUDA port of dlrover_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``models/``, ``trainer/``,
``obs/``, ``common/``) and imports nothing of it: where it needs a module
of the JAX package, it keeps its own copy. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
