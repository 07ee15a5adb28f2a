"""Carry model parameters between the JAX package and the port.

Every model family of the port names its modules and parameters as the
flax tree does, so one mapping serves them all: the flax path
``layer_0/attn/q_proj/kernel`` (Llama), ``block_3/qkv/kernel`` or
``block_0/ln1/scale`` (GPT), ``layer_0/attn_norm/bias`` (BERT),
``layer_0/moe/ExpertMLP_0/wi`` or ``layer_0/moe/router`` (LlamaMoE) is the
port's ``state_dict`` key with dots, and tables such as ``wte`` or
``word_embed`` keep their names. Dense kernels keep the ``(in, out)``
layout in both, so values cross unchanged. The tree is given as nested
dicts of numpy arrays (unbox flax's partitioning metadata first).

``factored_state_from_jax`` carries an optax chain's factored-RMS state
(``optax.adafactor``'s, or ``scale_by_factored_rms`` chained with
``scale``) to each parameter's per-leaf state by the port's names, the
layout of ``LeafOptimizer`` over ``optim.adafactor`` or
``optim.factored_rms``; ``streaming_state_from_jax`` carries the JAX
package's streaming state
(``trainer/streaming.py``: every block leaf stacked over the layers, the
optimizer's state stacked alike) to the port's per-layer parameters and
each one's factored-RMS state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# the per-leaf state of the factored-RMS optimizer (optim/factored.py)
FACTORED_KEYS = ("v_row", "v_col", "v")


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


def _flat(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested mappings → {dotted path: leaf}; a bare leaf is ``prefix``."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for name, child in tree.items():
        out.update(_flat(child, f"{prefix}.{name}" if prefix else name))
    return out


def _factored(opt_state: Any) -> Any:
    """The ``scale_by_factored_rms`` part of an optax chain's state (the
    part with ``v_row``)."""
    parts = [opt_state] if hasattr(opt_state, "v_row") else list(opt_state)
    for part in parts:
        if hasattr(part, "v_row"):
            return part
    raise ValueError("the optimizer state holds no scale_by_factored_rms "
                     "state")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def factored_state_from_jax(opt_state: Any
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An optax chain's state holding a ``scale_by_factored_rms`` (its
    leaves numpy arrays) → each parameter's ``{"count", "v_row", "v_col",
    "v"}`` by the port's names (``layer_0.moe.ExpertMLP_0.wi``)."""
    factored = _factored(opt_state)
    trees = {key: _flat(getattr(factored, key)) for key in FACTORED_KEYS}
    return {path: {"count": _tensor(factored.count),
                   **{key: _tensor(trees[key][path])
                      for key in FACTORED_KEYS}}
            for path in trees["v"]}


def streaming_state_from_jax(state: Any) -> Tuple[
        int, Dict[str, torch.Tensor], Dict[str, Dict[str, torch.Tensor]]]:
    """A JAX ``StreamingState`` (its leaves numpy arrays, its optimizer
    ``optax.chain(scale_by_factored_rms(), scale(-lr))``) → (step, the
    parameters by the port's names, each parameter's factored-RMS state
    ``{"count", "v_row", "v_col", "v"}`` by the same names): layer i of
    a stacked block leaf ``attn.q_proj.kernel`` is ``layer_{i}.attn
    .q_proj.kernel``, the tables ``embed`` and ``lm_head``, the final
    norm ``final_norm.weight``."""
    params: Dict[str, torch.Tensor] = {}
    opt: Dict[str, Dict[str, torch.Tensor]] = {}

    def leaf_state(factored, path: str, index=None) -> Dict[str, Any]:
        count = np.asarray(factored.count)
        out = {"count": _tensor(count if index is None else count[index])}
        for key in FACTORED_KEYS:
            value = _flat(getattr(factored, key))[path]
            out[key] = _tensor(value if index is None else value[index])
        return out

    blocks = _factored(state.block_opt)
    for path, leaf in _flat(state.block_params).items():
        for i in range(np.shape(leaf)[0]):
            params[f"layer_{i}.{path}"] = _tensor(np.asarray(leaf)[i])
            opt[f"layer_{i}.{path}"] = leaf_state(blocks, path, i)
    singles = [("embed", state.embed, state.embed_opt, ""),
               ("lm_head", state.head, state.head_opt, "")]
    singles += [(f"final_norm.{path}", leaf, state.norm_opt, path)
                for path, leaf in _flat(state.norm_params).items()]
    for name, value, opt_state, path in singles:
        if value is None:          # a tied head
            continue
        params[name] = _tensor(value)
        opt[name] = leaf_state(_factored(opt_state), path)
    return int(np.asarray(state.step)), params, opt
