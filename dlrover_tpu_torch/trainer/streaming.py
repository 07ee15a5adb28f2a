"""Streaming per-layer training step: a model whose whole gradient does
not fit beside its weights, on one card.

Counterpart of ``dlrover_tpu/trainer/streaming.py``. A dense step holds
every layer's gradient at once; with f32 weights Llama-7B's 26.96 GB of
weights and as much again of gradients, with the activations, do not fit
an 80 GB card beside an optimizer. This step walks the layers instead:

1. the forward runs under ``no_grad`` and stashes each block's input
   (the stash: ``(L, micro, seq, hidden)`` in ``cfg.dtype``);
2. the final norm and the head take an ordinary backward, the loss
   summed over sequence chunks of 512, 256 or 128 (each chunk's logits
   recomputed in the backward: one chunk of f32 logits is alive, not
   ``micro × seq × vocab``);
3. the reverse loop recomputes each block from its stashed input, takes
   ``torch.autograd.grad`` of it, updates that layer's parameters in
   place and frees its gradients before the next layer;
4. the embedding's backward runs last, with a tied head's gradient
   added to it.

Every layer's backward uses the parameters from before the step (an
update touches only layers already differentiated), so the step
computes what the dense step computes, up to the order of float sums.
Peak memory: the weights, one layer's gradients, the stash, and the
embedding's and head's gradients.

The optimizer must be per leaf (``dlrover_tpu_torch.optim``'s
``LeafTransform``: no state across leaves; global-norm clipping is not
one), and the step takes one micro-batch (``accum_steps`` 1): both are
refused otherwise, where the JAX package turns such a chain per-leaf
silently. The trainer has the dense ``Trainer``'s surface (``init``,
``abstract_state``, ``step``, ``shard_batch``, ``precompile``, ``mesh``),
so ``ElasticTrainLoop(..., trainer=...)`` checkpoints, restores and
reports it as it does the dense one.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    cross_entropy_loss,
    embed_lookup,
)
from dlrover_tpu_torch.optim.base import LeafOptimizer, LeafTransform
from dlrover_tpu_torch.parallel.mesh import Mesh, MeshSpec
from dlrover_tpu_torch.trainer.train_step import Trainer, TrainState

# the head's loss is summed over sequence chunks of the first of these
# that divides the length (else the whole length)
SEQ_CHUNKS = (512, 256, 128)


@dataclasses.dataclass
class StreamingState(TrainState):
    """The dense ``TrainState`` (step, the model, the per-leaf
    optimizer), so checkpoints and restores are the dense step's."""

    @property
    def params(self) -> Dict[str, Any]:
        """The JAX ``StreamingState.params`` view: each layer's
        parameters by name under ``blocks``, the embedding, the head
        (None when tied) and the final norm's parameters."""
        model, cfg = self.model, self.model.config
        blocks = [dict(getattr(model, f"layer_{i}").named_parameters())
                  for i in range(cfg.num_layers)]
        return {"blocks": blocks, "embed": model.embed,
                "head": None if cfg.tie_embeddings else model.lm_head,
                "norm": dict(model.final_norm.named_parameters())}


def _chunk_nll(x: torch.Tensor, head: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """Σ −log p(target) over a chunk: f32 logits of ``x @ head``."""
    logits = torch.matmul(x, head).float()
    return F.cross_entropy(logits.flatten(0, -2), targets.flatten(),
                           reduction="sum")


def head_loss(x: torch.Tensor, head: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of ``x @ head`` (x normalized,
    ``(b, s, hidden)``; ``head`` ``(hidden, vocab)`` in ``cfg.dtype``),
    summed chunk by chunk over the sequence, each chunk's logits
    recomputed in the backward."""
    b, s, _ = x.shape
    chunk = next((c for c in SEQ_CHUNKS if s % c == 0), s)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, chunk):
        total = total + checkpoint(
            _chunk_nll, x[:, start:start + chunk], head,
            targets[:, start:start + chunk], use_reentrant=False)
    return total / (b * s)


@dataclasses.dataclass
class StreamingTrainer(Trainer):
    """The dense ``Trainer`` with the streaming step (see the module
    docstring); built by :func:`build_streaming_trainer`."""

    config: Optional[LlamaConfig] = None

    def init(self, seed: int = 0) -> StreamingState:
        state = super().init(seed)
        return StreamingState(state.step, state.model, state.optimizer)

    def abstract_state(self) -> StreamingState:
        state = super().abstract_state()
        return StreamingState(state.step, state.model, state.optimizer)

    def step(self, state: StreamingState, tokens: torch.Tensor,
             targets: torch.Tensor) -> Tuple[StreamingState, dict]:
        """One optimizer step over one micro-batch ``(1, micro, seq)`` or
        ``(micro, seq)``. Returns the state and ``{"loss", "grad_norm"}``
        as 0-d tensors; the grad norm is the global one over every
        parameter's gradient, summed as they are made."""
        t0 = time.monotonic()
        try:
            return state, self._step(state, tokens, targets)
        finally:
            self.last_step_dispatch_s = time.monotonic() - t0

    def _step(self, state: StreamingState, tokens: torch.Tensor,
              targets: torch.Tensor) -> Dict[str, torch.Tensor]:
        if tokens.dim() == 3:
            if tokens.shape[0] != 1:
                raise ValueError(f"the streaming step takes one "
                                 f"micro-batch, got {tokens.shape[0]}")
            tokens, targets = tokens[0], targets[0]
        model, opt, cfg = state.model, state.optimizer, self.config
        blocks = [getattr(model, f"layer_{i}")
                  for i in range(cfg.num_layers)]
        positions = torch.arange(tokens.shape[-1], device=tokens.device
                                 ).expand(tokens.shape)
        sq_norm = torch.zeros((), dtype=torch.float32, device=tokens.device)

        lr = opt.param_groups[0]["lr"]

        def update(params: List[torch.Tensor],
                   grads: List[torch.Tensor]) -> None:
            nonlocal sq_norm
            for p, g in zip(params, grads):
                sq_norm = sq_norm + g.float().square().sum()
                opt.apply(p, g, lr)

        # forward: each block's input stashed, nothing saved for autograd
        stash: List[torch.Tensor] = []
        with torch.no_grad():
            h = embed_lookup(model.embed, tokens, cfg)
            for block in blocks:
                stash.append(h)
                h = block(h, positions)

        # the final norm and the head: an ordinary backward
        h = h.requires_grad_()
        norm_w = model.final_norm.weight
        head_p = model.embed if cfg.tie_embeddings else model.lm_head
        with torch.enable_grad():
            head = head_p.to(cfg.dtype)
            loss = head_loss(model.final_norm(h),
                             head.t() if cfg.tie_embeddings else head,
                             targets)
            dh, d_norm, d_head = torch.autograd.grad(loss,
                                                     (h, norm_w, head_p))
        del head
        update([norm_w], [d_norm])
        if not cfg.tie_embeddings:
            update([head_p], [d_head])
            d_head = None

        # backward: the blocks in reverse, each updated and freed at once
        for block in reversed(blocks):
            x = stash.pop().requires_grad_()
            params = list(block.parameters())
            with torch.enable_grad():
                out = block(x, positions)
                dh, *grads = torch.autograd.grad(out, [x] + params, dh)
            del out, x
            update(params, grads)
            del grads

        # the embedding's backward (a scatter-add of dh), the tied head's
        # gradient folded in
        with torch.enable_grad():
            looked_up = embed_lookup(model.embed, tokens, cfg)
            (d_embed,) = torch.autograd.grad(looked_up, (model.embed,), dh)
        if d_head is not None:
            d_embed = d_embed + d_head.to(d_embed.dtype)
        update([model.embed], [d_embed])
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": sq_norm.sqrt()}


def build_streaming_trainer(
    cfg: LlamaConfig,
    transform: LeafTransform,
    micro_batch: int,
    accum_steps: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> StreamingTrainer:
    """The streaming step of Llama ``cfg`` under a per-leaf optimizer
    (``dlrover_tpu_torch.optim``: ``factored_rms(3e-4)``, ``agd(...)``,
    ...) on one device (the current CUDA device when None; raises
    without a GPU unless ``device="cpu"``). Refuses an optimizer that is
    not a ``LeafTransform`` (a ``torch.optim`` factory or anything that
    may hold state across leaves, such as global-norm clipping) and
    ``accum_steps`` > 1."""
    if not isinstance(transform, LeafTransform):
        raise TypeError(
            f"the streaming step updates each layer as soon as its "
            f"gradient is made, so its optimizer must be per leaf (a "
            f"LeafTransform of dlrover_tpu_torch.optim); "
            f"{type(transform).__name__} may keep state across leaves "
            f"(global-norm clipping does)")
    if accum_steps != 1:
        raise ValueError(f"the streaming step takes one micro-batch a step "
                         f"(accum_steps=1), got accum_steps={accum_steps}")
    if not isinstance(cfg, LlamaConfig):
        raise TypeError(f"the streaming step runs the Llama decoder stack, "
                        f"got {type(cfg).__name__}")
    mesh = Mesh(MeshSpec(), resolve_device(device))
    libraries = Llama(cfg, device="meta").kernel_libraries()
    return StreamingTrainer(
        mesh=mesh, model_factory=functools.partial(Llama, cfg),
        optimizer_factory=functools.partial(LeafOptimizer,
                                            transform=transform),
        loss_fn=cross_entropy_loss, accum_steps=1, micro_batch=micro_batch,
        rules=[], libraries=libraries, config=cfg)
