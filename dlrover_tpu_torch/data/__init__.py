"""The input pipeline: ``prefetch.py`` (device prefetch over a side CUDA
stream and its data-wait-driven depth tuner), counterpart of
``dlrover_tpu/data``."""
