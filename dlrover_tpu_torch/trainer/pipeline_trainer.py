"""Pipelined transformer trainer: circular-schedule pipeline parallelism
over layer chunks.

Counterpart of ``dlrover_tpu/trainer/pipeline_trainer.py``. The model is
enter → N identical blocks → exit (``PipelineModelSpec``; Llama, the
Mixtral-style MoE, GPT and BERT ship built in). Its layers split into
S·C chunks (S the ``pipe`` size, C ``num_rounds``): layer ℓ = (r·S +
s)·layers_per_chunk + j is block j of chunk r·S + s, on stage s. Where
the JAX package stacks every block's leaves as (C, S, layers_per_chunk,
...) and shards the stage dim over ``pipe``, a pipe rank here builds only
its own stage (``PipelineStage``): the shared parameters (embedding,
final norm, head) under the spec's names and its layers' blocks as
``{layer_prefix}_{ℓ}``, the dense model's names, so a checkpoint's keys
do not depend on the pipe size and ``convert.pipeline_params_{from,
to}_jax`` map the JAX layout. The stage's forward runs
``parallel/pipeline.py::pipeline_train``; the embedding runs on stage 0
and the exit on the last stage, inside the pipeline.

The trainer has the dense ``Trainer``'s surface (``init``,
``abstract_state``, ``step``, ``shard_batch``, ``accum_steps`` = the
microbatches M, ``micro_batch``, ``mesh``, ``offload_opt_state``), so
``ElasticTrainLoop(..., trainer=...)`` checkpoints, restores and reports
it; ``param_stats`` gives the loop every stage's parameter count, as the
JAX loop counts its global abstract state. A step: one backward of the
whole schedule, then the shared parameters' gradients summed over the
pipe group, then every gradient averaged over the data axes (FSDP2 over
each stage's (data, fsdp) sub-mesh, as the dense trainer lays a model
out by the logical-axis rules; the replicated leaves by all-reduce). The
grad norm sums each stage's chunks and the shared leaves once.

A ``tensor`` axis (pipe × tensor) lays each stage's blocks out as the
dense trainer lays a model (DTensors over the stage's tensor group by
the logical-axis rules, the JAX ``_param_shardings``' ``P(None, pipe,
None, *logical)`` of the chunk leaves), and the shared parameters keep
their tensor shardings (the vocabulary-sharded embedding and head); their
gradients are summed over the pipe group only. An ``expert`` axis
(pipe × expert) shards an MoE chunk's experts over the stage's expert
group, as JAX keeps that axis automatic inside its pipe-manual region.
The exits take the dense models' placement of the tensor axis's sums
(``parallel/tensor_parallel.py``). The ring carries plain activations
replicated over ``tensor`` (``parallel/pipeline.py``).

Refused: a ``sequence`` axis, which the JAX pipelined trainer does not
split either (its batch is sharded over the data axes alone). Not
copied: the XLA-CPU f32 forcing of MoE pipelines.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor.experimental import implicit_replication

from dlrover_tpu_torch.common.constants import MeshAxis
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.layers import Dense, LayerNorm, gelu, \
    normal_param
from dlrover_tpu_torch.models.llama import (
    DecoderBlock,
    LlamaConfig,
    RMSNorm,
    embed_lookup,
)
from dlrover_tpu_torch.parallel.collectives import all_reduce_
from dlrover_tpu_torch.parallel.mesh import Mesh, create_mesh, dp_size
from dlrover_tpu_torch.parallel.moe import fold_seed
from dlrover_tpu_torch.parallel.pipeline import pipeline_train
from dlrover_tpu_torch.parallel.sharding import DEFAULT_RULES, to_local
from dlrover_tpu_torch.parallel.tensor_parallel import (
    column_parallel_input,
    gather_shards,
)
from dlrover_tpu_torch.trainer.train_step import (
    Trainer,
    _check_model_axes,
    _global_norm,
)


def per_row(loss_fn):
    """A batch-mean loss (logits, targets) → scalar, applied row by row:
    (micro, seq, V), (micro, seq) → (micro,). The pipeline averages the
    rows itself (JAX's ``_per_row``)."""

    def row_losses(logits, targets):
        return torch.stack([loss_fn(lg[None], tg[None])
                            for lg, tg in zip(logits, targets)])

    return row_losses


@dataclasses.dataclass
class PipelineModelSpec:
    """What the pipeline needs to know of a stacked-block model. The JAX
    spec's ``init_layer``/``init_shared`` are ``make_layer``/
    ``make_shared`` here, and its logical axes (``abstract_layer``,
    ``shared_logical``) are the modules' ``param_axes``."""

    num_layers: int
    # layer ℓ's module is f"{layer_prefix}_{ℓ}", as in the dense model
    layer_prefix: str
    # (device, generator) -> one block
    make_layer: Callable[..., nn.Module]
    # (stage, device, generator): registers the shared parameters and
    # modules on the stage under the dense model's names
    make_shared: Callable[..., None]
    # (blocks of a chunk, act) -> act, or (act, aux) when has_aux
    chunk_fn: Callable[[Sequence[nn.Module], torch.Tensor], Any]
    # (stage, tokens_micro) -> (micro, seq, H)
    enter_fn: Callable[[nn.Module, torch.Tensor], torch.Tensor]
    # (stage, act, targets_micro) -> (micro,) per-row losses
    exit_fn: Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]
    has_aux: bool = False


class PipelineStage(nn.Module):
    """One pipe rank's part of the model: the shared parameters and the
    blocks of ``layers`` (ascending), each block made from a generator
    seeded by (seed, ℓ + 1) and the shared ones by (seed, 0), so the
    weights do not depend on the pipe size. Built on ``meta``, it
    allocates nothing (the restore target)."""

    def __init__(self, spec: PipelineModelSpec, layers: Sequence[int],
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.layers = list(layers)

        def generator(*parts):
            if device.type == "meta":
                return None
            return torch.Generator(device=device).manual_seed(
                fold_seed(seed, *parts))

        spec.make_shared(self, device, generator(0))
        self.shared_names = [name for name, _ in self.named_parameters()]
        for layer in self.layers:
            self.add_module(f"{spec.layer_prefix}_{layer}",
                            spec.make_layer(device, generator(layer + 1)))

    def chunks(self, num_rounds: int) -> List[List[nn.Module]]:
        """This stage's blocks by round: chunk r·S + s at index r."""
        per = len(self.layers) // num_rounds
        blocks = [getattr(self, f"{self.spec.layer_prefix}_{layer}")
                  for layer in self.layers]
        return [blocks[r * per:(r + 1) * per] for r in range(num_rounds)]

    def forward(self, tokens: torch.Tensor, targets: torch.Tensor,
                mesh: Mesh, num_rounds: int = 1, remat: bool = False,
                activation_groups: int = 0) -> torch.Tensor:
        """The pipelined loss of (M, micro, seq) tokens/targets (see
        ``pipeline_train``)."""
        spec = self.spec
        return pipeline_train(
            mesh, spec.chunk_fn, self.chunks(num_rounds), self,
            spec.enter_fn, spec.exit_fn, tokens, targets,
            num_rounds=num_rounds, remat=remat, chunk_has_aux=spec.has_aux,
            activation_groups=activation_groups)


# ---------------------------------------------------------------------------
# built-in specs: Llama, the MoE Llama, GPT, BERT
# ---------------------------------------------------------------------------


def _blocks_in_turn(blocks, h):
    """GPT's and BERT's chunk: each block on the activation alone."""
    for block in blocks:
        h = block(h)
    return h


def _positions(h: torch.Tensor) -> torch.Tensor:
    return torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])


def _llama_shared(cfg: LlamaConfig):
    """The Llama exit's shared parameters: ``embed``, ``final_norm``
    (the plain norm in f32: JAX's exit calls ``reference_rms_norm``) and
    an untied ``lm_head``, whatever ``cfg.tie_embeddings`` says."""
    norm_cfg = dataclasses.replace(cfg, norm_impl="reference")

    def make_shared(stage, device, generator):
        h, v = cfg.hidden_size, cfg.vocab_size
        stage.param_axes = {"embed": ("vocab", "embed"),
                            "lm_head": ("embed", "vocab")}
        stage.embed = normal_param((v, h), 0.02, cfg, device, generator)
        stage.final_norm = RMSNorm(h, norm_cfg, device)
        stage.lm_head = normal_param((h, v), 0.02, cfg, device, generator)

    return make_shared


def llama_pipeline_spec(cfg: LlamaConfig, loss_fn) -> PipelineModelSpec:
    """Llama: a gather embedding, the decoder blocks, the plain final
    norm and an untied head with f32 logits."""
    row_losses = per_row(loss_fn)

    def chunk_fn(blocks, h):
        positions = _positions(h)
        for block in blocks:
            h = block(h, positions)
        return h

    def enter_fn(stage, tokens):
        return embed_lookup(stage.embed, tokens, cfg)

    def exit_fn(stage, h, targets):
        h = column_parallel_input(stage.final_norm(h))
        logits = torch.matmul(h, stage.lm_head.to(cfg.dtype)).float()
        return row_losses(logits, targets)

    return PipelineModelSpec(
        num_layers=cfg.num_layers, layer_prefix="layer",
        make_layer=lambda device, gen: DecoderBlock(cfg, device, gen),
        make_shared=_llama_shared(cfg), chunk_fn=chunk_fn,
        enter_fn=enter_fn, exit_fn=exit_fn)


def llama_moe_pipeline_spec(cfg, loss_fn) -> PipelineModelSpec:
    """The MoE decoder blocks through the pipeline, the Llama spec's
    enter and exit: ``MoEDecoderBlock(cfg, deterministic=True)`` (the
    eval capacity factor, no jitter), each chunk's aux losses summed over
    its layers and carried through the pipeline's aux accumulator."""
    from dlrover_tpu_torch.models.llama_moe import MoEDecoderBlock

    def chunk_fn(blocks, h):
        positions = _positions(h)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for block in blocks:
            h, layer_aux = block(h, positions)
            aux = aux + layer_aux
        return h, aux

    return dataclasses.replace(
        llama_pipeline_spec(cfg, loss_fn),
        make_layer=lambda device, gen: MoEDecoderBlock(cfg, True, device,
                                                       gen),
        chunk_fn=chunk_fn, has_aux=True)


def gpt_pipeline_spec(cfg, loss_fn) -> PipelineModelSpec:
    """GPT: token and position embeddings, the pre-LN blocks, ``ln_f``
    and the head tied to ``wte``."""
    from dlrover_tpu_torch.models.gpt import LN_EPS, Block

    row_losses = per_row(loss_fn)

    def make_shared(stage, device, generator):
        n = cfg.n_embd
        stage.param_axes = {"wte": ("vocab", "embed"),
                            "wpe": (None, "embed")}
        stage.wte = normal_param((cfg.vocab_size, n), 0.02, cfg, device,
                                 generator)
        stage.wpe = normal_param((cfg.block_size, n), 0.02, cfg, device,
                                 generator)
        stage.ln_f = LayerNorm(n, LN_EPS, cfg, device)

    def enter_fn(stage, tokens):
        return (embed_lookup(stage.wte, tokens, cfg)
                + stage.wpe[:tokens.shape[-1]].to(cfg.dtype))

    def exit_fn(stage, h, targets):
        logits = torch.matmul(column_parallel_input(stage.ln_f(h)),
                              stage.wte.to(cfg.dtype).t())
        return row_losses(logits.float(), targets)

    return PipelineModelSpec(
        num_layers=cfg.n_layer, layer_prefix="block",
        make_layer=lambda device, gen: Block(cfg, device, gen),
        make_shared=make_shared, chunk_fn=_blocks_in_turn,
        enter_fn=enter_fn, exit_fn=exit_fn)


def bert_pipeline_spec(cfg, loss_fn) -> PipelineModelSpec:
    """BERT: word and position embeddings and ``embed_norm`` (token types
    ride as zeros: no segment table), the post-LN encoder blocks, and the
    MLM transform, gelu, ``mlm_norm`` and the decoder tied to the word
    table, without a bias."""
    from dlrover_tpu_torch.models.bert import EncoderBlock

    row_losses = per_row(loss_fn)

    def make_shared(stage, device, generator):
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        stage.param_axes = {"word_embed": ("vocab", "embed"),
                            "pos_embed": (None, "embed")}
        stage.word_embed = normal_param((cfg.vocab_size, h), 0.02, cfg,
                                        device, generator)
        stage.pos_embed = normal_param((cfg.max_seq_len, h), 0.02, cfg,
                                       device, generator)
        stage.embed_norm = LayerNorm(h, eps, cfg, device)
        stage.mlm_transform = Dense(h, h, ("embed", "mlp"), cfg, device,
                                    generator)
        stage.mlm_norm = LayerNorm(h, eps, cfg, device)

    def enter_fn(stage, tokens):
        h = (embed_lookup(stage.word_embed, tokens, cfg)
             + stage.pos_embed[:tokens.shape[-1]].to(cfg.dtype))
        return stage.embed_norm(h)

    def exit_fn(stage, h, targets):
        # the transform's columns are sharded over a tensor axis: made
        # whole for the norm (the dense model's placement)
        h = gather_shards(gelu(stage.mlm_transform(column_parallel_input(h))))
        logits = torch.matmul(column_parallel_input(stage.mlm_norm(h)),
                              stage.word_embed.to(cfg.dtype).t())
        return row_losses(logits.float(), targets)

    return PipelineModelSpec(
        num_layers=cfg.num_layers, layer_prefix="layer",
        make_layer=lambda device, gen: EncoderBlock(cfg, device, gen),
        make_shared=make_shared, chunk_fn=_blocks_in_turn,
        enter_fn=enter_fn, exit_fn=exit_fn)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PipelinedTrainer(Trainer):
    """The dense ``Trainer``'s surface over a ``PipelineStage`` (see the
    module docstring); built by :func:`build_pipeline_trainer`."""

    spec: Optional[PipelineModelSpec] = None
    num_rounds: int = 1
    remat: bool = False
    bound_activations: bool = False

    def __post_init__(self):
        self.model_factory = self.build_stage

    @property
    def num_stages(self) -> int:
        return self.mesh.shape[MeshAxis.PIPE]

    @property
    def num_chunks(self) -> int:
        return self.num_stages * self.num_rounds

    @property
    def layers_per_chunk(self) -> int:
        if self.spec.num_layers % self.num_chunks:
            raise ValueError(
                f"{self.spec.num_layers} layers not divisible by "
                f"{self.num_chunks} chunks ({self.num_stages} stages × "
                f"{self.num_rounds} rounds)")
        return self.spec.num_layers // self.num_chunks

    def stage_layers(self, stage: int) -> List[int]:
        """The layers stage ``stage`` holds: ℓ = (r·S + s)·per + j."""
        per, s = self.layers_per_chunk, self.num_stages
        return [(r * s + stage) * per + j
                for r in range(self.num_rounds) for j in range(per)]

    def build_stage(self, device=None, seed: int = 0) -> PipelineStage:
        """This rank's stage (the dense trainer's model factory)."""
        return PipelineStage(
            self.spec,
            self.stage_layers(self.mesh.coordinate()[MeshAxis.PIPE]),
            device=device, seed=seed)

    def param_stats(self) -> Tuple[int, int]:
        """(parameters, bytes) of every stage, as the JAX loop counts its
        global abstract state: the model built whole on ``meta``."""
        whole = PipelineStage(self.spec, range(self.spec.num_layers),
                              device="meta")
        params = list(whole.parameters())
        return (sum(p.numel() for p in params),
                sum(p.numel() * p.element_size() for p in params))

    def _pipe_group(self):
        return self.mesh.submesh([MeshAxis.PIPE]).get_group()

    def _accumulate(self, state, tokens: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
        """The whole schedule's forward and one backward: leaves the
        gradients of the global mean loss in ``.grad`` (the shared ones
        summed over the pipe group, all averaged over the data axes) and
        returns the loss."""
        model = state.model
        model.zero_grad(set_to_none=True)
        # plain tensors (positions, the batch) meet DTensor parameters as
        # replicated values
        with implicit_replication():
            loss = model(tokens, targets, self.mesh, self.num_rounds,
                         self.remat,
                         self.num_stages if self.bound_activations else 0)
            loss.backward()
        loss = loss.detach().float()
        for p in model.parameters():
            if p.grad is None:
                # a shared parameter this stage's enter and exit do not
                # touch: its part of the sum over pipe is zero
                p.grad = torch.zeros_like(p)
        params = dict(model.named_parameters())
        if self.num_stages > 1:
            # over the pipe group only: a stage's tensor or expert shard
            # of a shared leaf meets the same shard of the other stages
            all_reduce_([to_local(params[name].grad)
                         for name in model.shared_names], self._pipe_group())
        group = self._dp_group()
        if group is not None:
            dp = dp_size(self.mesh)
            for name in getattr(model, "dp_replicated_params", ()):
                grad = to_local(params[name].grad)
                dist.all_reduce(grad, group=group)
                grad.div_(dp)
            dist.all_reduce(loss, group=group)
            loss /= dp
        return loss

    def _grad_norm(self, model: nn.Module) -> torch.Tensor:
        """sqrt of every stage's chunk gradients' Σg² (summed over the
        pipe group) plus the shared ones', counted once."""
        shared = set(model.shared_names)
        named = list(model.named_parameters())
        chunk_sq = _global_norm([p.grad for n, p in named
                                 if n not in shared]).square()
        if self.num_stages > 1:
            dist.all_reduce(chunk_sq, group=self._pipe_group())
        shared_sq = _global_norm([p.grad for n, p in named
                                  if n in shared]).square()
        return (chunk_sq + shared_sq).sqrt()


def _kernel_libraries(cfg) -> Tuple[str, ...]:
    """The CUDA libraries (``ops/csrc/<name>.cu``) a step of ``cfg``'s
    blocks launches kernels from (the models' ``kernel_libraries``)."""
    return (("flash_attention",) if cfg.attn_impl == "flash" else ()) + (
        ("norms",) if getattr(cfg, "norm_impl", "") == "fused" else ())


def build_pipeline_trainer(cfg, optimizer_factory: Callable[..., Any],
                           mesh: Optional[Mesh], num_microbatches: int,
                           micro_batch: int, seq_len: int, loss_fn,
                           num_rounds: int = 1, remat: bool = False,
                           rules: Optional[Sequence] = None,
                           offload_opt_state: bool = False,
                           bound_activations: bool = False,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> PipelinedTrainer:
    """A pipelined trainer for a Llama, MoE Llama, GPT or BERT config.

    ``optimizer_factory(params)`` as for ``build_trainer``; ``mesh`` from
    ``create_mesh`` (None: this process alone, on ``device``, which is
    the current CUDA device when None and raises without a GPU unless
    ``"cpu"``). ``micro_batch`` rows a microbatch over the whole world
    (sharded over the data axes), ``num_microbatches`` of them a step.
    ``loss_fn``: a batch-mean loss (logits, targets) → scalar
    (``cross_entropy_loss``, ``mlm_loss``), applied row by row.
    ``remat`` checkpoints each chunk call; ``bound_activations`` each
    schedule step (``pipeline_train``'s ``activation_groups``).
    ``offload_opt_state``: the optimizer's moments in pinned host memory
    between steps."""
    from dlrover_tpu_torch.models.bert import BertConfig
    from dlrover_tpu_torch.models.gpt import GPTConfig
    from dlrover_tpu_torch.models.llama_moe import LlamaMoEConfig

    if mesh is None:
        mesh = create_mesh(device=device)
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    shape = mesh.shape
    if shape[MeshAxis.SEQUENCE] > 1:
        raise NotImplementedError(
            "the pipelined trainer does not split the sequence: its batch "
            "is sharded over the data axes alone, as the JAX "
            "PipelinedTrainer's (P(None, data axes)); train a sequence "
            "axis with build_trainer")
    # LlamaMoEConfig subclasses LlamaConfig: checked first
    if isinstance(cfg, LlamaMoEConfig):
        spec = llama_moe_pipeline_spec(cfg, loss_fn)
    elif isinstance(cfg, LlamaConfig):
        spec = llama_pipeline_spec(cfg, loss_fn)
    elif isinstance(cfg, GPTConfig):
        spec = gpt_pipeline_spec(cfg, loss_fn)
    elif isinstance(cfg, BertConfig):
        spec = bert_pipeline_spec(cfg, loss_fn)
    else:
        raise NotImplementedError(
            f"no pipeline spec for {type(cfg).__name__}; provide a "
            f"PipelineModelSpec and construct PipelinedTrainer directly")
    positions = getattr(cfg, "block_size", None) or cfg.max_seq_len
    if seq_len > positions:
        raise ValueError(f"seq_len {seq_len} exceeds the model's "
                         f"{positions} positions")
    if micro_batch % dp_size(mesh):
        raise ValueError(f"micro batch {micro_batch} does not divide over "
                         f"{dp_size(mesh)} data-parallel ranks")
    trainer = PipelinedTrainer(
        mesh=mesh, model_factory=None, optimizer_factory=optimizer_factory,
        loss_fn=loss_fn, accum_steps=num_microbatches,
        micro_batch=micro_batch,
        rules=list(rules if rules is not None else DEFAULT_RULES),
        offload_opt_state=offload_opt_state,
        libraries=_kernel_libraries(cfg),
        spec=spec, num_rounds=num_rounds, remat=remat,
        bound_activations=bound_activations)
    _ = trainer.layers_per_chunk   # layers that do not divide: ValueError
    # every dim the tensor or expert axis shards must divide by it
    whole = PipelineStage(spec, range(spec.num_layers), "meta")
    whole.config = cfg
    _check_model_axes(whole, mesh, trainer.rules)
    trainer._stage_lanes()
    return trainer
