"""Carry model parameters between the JAX package and the port.

Every model family of the port names its modules and parameters as the
flax tree does, so one mapping serves them all: the flax path
``layer_0/attn/q_proj/kernel`` (Llama), ``block_3/qkv/kernel`` or
``block_0/ln1/scale`` (GPT), ``layer_0/attn_norm/bias`` (BERT),
``layer_0/moe/ExpertMLP_0/wi`` or ``layer_0/moe/router`` (LlamaMoE) is the
port's ``state_dict`` key with dots, and tables such as ``wte`` or
``word_embed`` keep their names. Dense kernels keep the ``(in, out)``
layout in both, so values cross unchanged, but for one pair of leaves:
GPT's and BERT's fused ``qkv`` kernel and bias, which the port stores
head-major (each head's q, k and v columns side by side, so that a
column shard over a tensor axis is whole heads: ``models/gpt.py``) and
flax as ``[q | k | v]``. Every converter permutes their last dim, and
the optimizer state's that follows it, and takes the model's head count
as ``heads`` for it (a tree holding a ``qkv`` leaf without it raises).
The tree is given as nested dicts of numpy arrays (unbox flax's
partitioning metadata first).

``factored_state_from_jax`` carries an optax chain's factored-RMS state
(``optax.adafactor``'s, or ``scale_by_factored_rms`` chained with
``scale``) to each parameter's per-leaf state by the port's names, the
layout of ``LeafOptimizer`` over ``optim.adafactor`` or
``optim.factored_rms``; ``streaming_state_from_jax`` carries the JAX
package's streaming state
(``trainer/streaming.py``: every block leaf stacked over the layers, the
optimizer's state stacked alike) to the port's per-layer parameters and
each one's factored-RMS state.

A state dict's DTensors (a tensor- or expert-sharded stage or model)
cross as whole arrays: each rank of their mesh gathers them alike.

``pipeline_params_from_jax`` and ``pipeline_params_to_jax`` carry the JAX
``PipelinedTrainer``'s parameters (``{"shared": ..., "chunks": ...}``,
every block leaf stacked as (C, S, layers_per_chunk, ...)) to the port's
``PipelineStage`` names and back: layer ℓ = (r·S + s)·layers_per_chunk +
j's leaves under ``layer_{ℓ}`` (GPT's ``block_{ℓ}``), the shared ones by
their names (Llama's bare ``final_norm`` as ``final_norm.weight``);
``pipeline_adamw_from_jax`` carries an ``optax.adamw`` state of those
parameters to ``torch.optim.AdamW``'s per-parameter state.

``embedding_state_from_jax`` carries the JAX ``ElasticEmbeddingTrainer``'s
state (embed params, ``RowSparseAdagradState``, dense params,
``optax.adam``'s state) to the port's ``EmbeddingTrainState`` names, for
``ElasticEmbeddingTrainer.load_state``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

# the per-leaf state of the factored-RMS optimizer (optim/factored.py)
FACTORED_KEYS = ("v_row", "v_col", "v")
# the fused projections the port stores head-major (GPT's, BERT's)
QKV_LEAVES = (".qkv.kernel", ".qkv.bias")


def qkv_to_port(value: np.ndarray, heads: int) -> np.ndarray:
    """flax's ``[q | k | v]`` columns (the last dim, 3·heads·head_dim) →
    the port's head-major ``[head 0: q, k, v | head 1: q, k, v | …]``."""
    *lead, width = value.shape
    return np.ascontiguousarray(np.swapaxes(value.reshape(
        *lead, 3, heads, width // (3 * heads)), -3, -2).reshape(value.shape))


def qkv_to_jax(value: np.ndarray, heads: int) -> np.ndarray:
    """The inverse of ``qkv_to_port``."""
    *lead, width = value.shape
    return np.ascontiguousarray(np.swapaxes(value.reshape(
        *lead, heads, 3, width // (3 * heads)), -3, -2).reshape(value.shape))


def _relayout(name: str, value: np.ndarray, heads: Optional[int],
              permute) -> np.ndarray:
    """``value`` of leaf ``name`` through ``permute`` when the leaf is a
    fused qkv (its columns, or a state tensor that follows them)."""
    if not name.endswith(QKV_LEAVES):
        return value
    if heads is None:
        raise ValueError(f"{name} is a fused qkv leaf, stored head-major "
                         f"in the port: pass the model's head count "
                         f"(heads=)")
    return permute(value, heads)


def params_from_jax(tree: Mapping[str, Any], heads: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) → flat ``state_dict``;
    ``heads``: the model's head count, for a fused qkv."""
    return {key: _tensor(_relayout(key, np.asarray(value), heads,
                                   qkv_to_port))
            for key, value in _flat(tree).items()}


def _host(tensor: torch.Tensor) -> np.ndarray:
    """A tensor's whole value in host memory: a DTensor's (a tensor- or
    expert-sharded leaf) gathered first, which every rank of its mesh
    calls alike."""
    if isinstance(tensor, DTensor):
        tensor = tensor.full_tensor()
    return tensor.detach().cpu().numpy()


def params_to_jax(state_dict: Mapping[str, torch.Tensor],
                  heads: Optional[int] = None) -> Dict[str, Any]:
    """Flat ``state_dict`` → flax param tree of numpy arrays; ``heads``
    as ``params_from_jax``'s."""
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = _relayout(key, _host(tensor), heads, qkv_to_jax)
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


def factored_state_from_jax(opt_state: Any, heads: Optional[int] = None
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An optax chain's state holding a ``scale_by_factored_rms`` (its
    leaves numpy arrays) → each parameter's ``{"count", "v_row", "v_col",
    "v"}`` by the port's names (``layer_0.moe.ExpertMLP_0.wi``). A fused
    qkv's column statistics (``v_col``, and an unfactored ``v``) permute
    with its columns; its row statistics (``v_row``) stay."""
    factored = _factored(opt_state)
    trees = {key: _flat(getattr(factored, key)) for key in FACTORED_KEYS}

    def leaf(key, path):
        value = np.asarray(trees[key][path])
        if key == "v_row" or value.shape[-1] == 1:
            # row statistics, or the placeholder of a factored part
            return _tensor(value)
        return _tensor(_relayout(path, value, heads, qkv_to_port))

    return {path: {"count": _tensor(factored.count),
                   **{key: leaf(key, path) for key in FACTORED_KEYS}}
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


# pipeline spec family → (its blocks' name prefix, {JAX shared path: the
# port's name} where they differ)
PIPELINE_LAYOUTS = {
    "llama": ("layer", {"final_norm": "final_norm.weight"}),
    "llama_moe": ("layer", {"final_norm": "final_norm.weight"}),
    "gpt": ("block", {}),
    "bert": ("layer", {}),
}


def _chunk_layers(leaf_shape, stage: Optional[int]):
    """((r, s, j) index, layer ℓ) of a (C, S, per, ...) chunk leaf, for
    every stage or one."""
    rounds, stages, per = leaf_shape[:3]
    for r in range(rounds):
        for s in range(stages):
            if stage is not None and s != stage:
                continue
            for j in range(per):
                yield (r, s, j), (r * stages + s) * per + j


def _pipeline_items(tree: Mapping[str, Any], family: str,
                    stage: Optional[int], heads: Optional[int]):
    """(the port's name, numpy value) of a {"shared", "chunks"} tree, a
    fused qkv in the port's layout."""
    prefix, renames = PIPELINE_LAYOUTS[family]
    for path, leaf in _flat(tree["shared"]).items():
        yield renames.get(path, path), np.asarray(leaf)
    for path, leaf in _flat(tree["chunks"]).items():
        leaf = np.asarray(leaf)
        for index, layer in _chunk_layers(leaf.shape, stage):
            name = f"{prefix}_{layer}.{path}"
            yield name, _relayout(name, leaf[index], heads, qkv_to_port)


def pipeline_params_from_jax(params: Mapping[str, Any], family: str,
                             stage: Optional[int] = None,
                             heads: Optional[int] = None
                             ) -> Dict[str, torch.Tensor]:
    """A JAX pipelined trainer's parameters (numpy leaves) → the port's
    by name: stage ``stage``'s (a ``PipelineStage``'s ``state_dict``),
    or every layer's when None (the dense model's names). ``family``: a
    key of ``PIPELINE_LAYOUTS``; ``heads``: GPT's or BERT's head count,
    for the fused qkv."""
    return {name: _tensor(value) for name, value in
            _pipeline_items(params, family, stage, heads)}


def pipeline_params_to_jax(state_dict: Mapping[str, torch.Tensor],
                           family: str, num_stages: int,
                           num_rounds: int = 1,
                           heads: Optional[int] = None) -> Dict[str, Any]:
    """Every layer's parameters by the port's names (the stages'
    ``state_dict``s merged) → the JAX ``{"shared", "chunks"}`` tree of
    numpy arrays, chunk leaves (C, S, layers_per_chunk, ...); ``heads``
    as ``pipeline_params_from_jax``'s."""
    prefix, renames = PIPELINE_LAYOUTS[family]
    back = {port: path for path, port in renames.items()}
    shared: Dict[str, Any] = {}
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for name, tensor in state_dict.items():
        value = _relayout(name, _host(tensor), heads, qkv_to_jax)
        head, _, rest = name.partition(".")
        if head.startswith(prefix + "_") and head[len(prefix) + 1:].isdigit():
            layers.setdefault(int(head[len(prefix) + 1:]), {})[rest] = value
        else:
            shared[back.get(name, name)] = value
    per = len(layers) // (num_stages * num_rounds)
    stacked = {
        path: np.stack([layers[i][path] for i in range(len(layers))])
        .reshape((num_rounds, num_stages, per)
                 + layers[0][path].shape)
        for path in layers[0]}
    return {"shared": params_to_jax({k: torch.from_numpy(v)
                                     for k, v in shared.items()}),
            "chunks": params_to_jax({k: torch.from_numpy(v)
                                     for k, v in stacked.items()})}


def pipeline_adamw_from_jax(opt_state: Any, family: str,
                            heads: Optional[int] = None
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An ``optax.adamw`` state of a JAX pipelined trainer's parameters
    (numpy leaves) → each parameter's ``torch.optim.AdamW`` state
    ``{"step", "exp_avg", "exp_avg_sq"}`` by the port's names, every
    layer's (a stage takes its own by name); a fused qkv's moments
    permute with its columns (``heads``: GPT's or BERT's head count)."""
    adam = next(part for part in opt_state if hasattr(part, "mu"))
    step = torch.tensor(float(np.asarray(adam.count)))
    mu = dict(_pipeline_items(adam.mu, family, None, heads))
    nu = dict(_pipeline_items(adam.nu, family, None, heads))
    return {name: {"step": step.clone(), "exp_avg": _tensor(mu[name]),
                   "exp_avg_sq": _tensor(nu[name])} for name in mu}


def embedding_state_from_jax(state: Tuple[Any, Any, Any, Any]
                             ) -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, Dict[str, torch.Tensor]]]:
    """The JAX embedding trainer's ``(embed_params, embed_opt,
    dense_params, dense_opt)`` (numpy leaves; the dense tree a mapping
    whose dotted paths are the port's dense tower's parameter names) →
    (parameters by the port's ``EmbeddingModel`` names, each one's
    optimizer state): ``embedding.table`` with the row-sparse Adagrad
    ``accumulator``, ``dense.<path>`` with ``torch.optim.Adam``'s
    ``step``, ``exp_avg`` and ``exp_avg_sq`` from optax.adam's ``count``,
    ``mu`` and ``nu``."""
    embed_params, embed_opt, dense_params, dense_opt = state
    params = {"embedding.table": _tensor(embed_params["table"])}
    opt = {"embedding.table": {
        "accumulator": _tensor(embed_opt.accumulator["table"])}}
    adam = next(part for part in (
        [dense_opt] if hasattr(dense_opt, "mu") else list(dense_opt))
        if hasattr(part, "mu"))
    step = torch.tensor(float(np.asarray(adam.count)))
    mu, nu = _flat(adam.mu), _flat(adam.nu)
    for path, value in _flat(dense_params).items():
        name = f"dense.{path}"
        params[name] = _tensor(value)
        opt[name] = {"step": step.clone(), "exp_avg": _tensor(mu[path]),
                     "exp_avg_sq": _tensor(nu[path])}
    return params, opt
