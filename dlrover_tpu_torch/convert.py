"""Carry model parameters between the JAX package and the port.

Every model family of the port names its modules and parameters as the
flax tree does, so one mapping serves them all: the flax path
``layer_0/attn/q_proj/kernel`` (Llama), ``block_3/qkv/kernel`` or
``block_0/ln1/scale`` (GPT), ``layer_0/attn_norm/bias`` (BERT) is the
port's ``state_dict`` key with dots, and tables such as ``wte`` or
``word_embed`` keep their names. Dense kernels keep the ``(in, out)``
layout in both, so values cross unchanged. The tree is given as nested
dicts of numpy arrays (unbox flax's partitioning metadata first).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) → flat ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name, child in node.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(child, Mapping):
                walk(child, key)
            else:
                out[key] = torch.from_numpy(np.array(child, copy=True))

    walk(tree, "")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Any]:
    """Flat ``state_dict`` → flax param tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = tensor.detach().cpu().numpy()
    return tree
