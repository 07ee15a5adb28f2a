"""Pipeline parallelism over the ``pipe`` axis: the circular schedule.

Counterpart of ``dlrover_tpu/parallel/pipeline.py``. The JAX package runs
every stage as one SPMD program under a ``shard_map`` manual over
``pipe`` and lets ``jax.grad`` through ``scan`` + ``ppermute`` give the
backward pipeline. Here each pipe rank is its own process: it runs its
stage's steps of the same schedule, and its activations cross to the
next stage with ``torch.distributed`` point-to-point operations
(``batch_isend_irecv``: send to stage s+1, receive from s−1, a ring as
the ``ppermute``). At one stage the shift is the identity and sends
nothing.

The schedule is the JAX one, step for step (``schedule_steps`` and
``slot`` are its formulas, pure functions): layers split into S·C
chunks, chunk g on stage g % S, each activation looping the ring C
times (``num_rounds``); ceil(M/S)·S·C + S − 1 steps, stage s at step t
holding microbatch m of round r (``slot``). The bubble the planner
prices, ``accum/(accum + pipe − 1)``, is this schedule's.

The backward: each shift is an autograd function whose forward sends y
to s+1 and receives from s−1 and whose backward sends the received
activation's gradient to s−1 and receives y's from s+1. Every rank's
steps form one chain through its shifts (the first step's input
requires a gradient, an invalid step passes its input through, and the
last step's output reaches the loss at zero weight), so a single
``backward()`` runs every shift's backward on every rank, in reverse
step order, and no peer waits for a gradient that never comes. Where
JAX selects the fresh microbatch with ``jnp.where`` on the stage index,
stage 0 replaces the ring's activation by the embedding in a function
that gives the ring's activation a zero gradient, so the shift that
delivered it still runs its backward.

Enter and exit branch on the stage: the embedding (``enter_fn``) runs
only on stage 0 at the steps that inject a microbatch, the final norm,
head and per-row loss (``exit_fn``) only on the last stage at the steps
that finish one, and a rank skips the steps its stage holds no valid
microbatch in. JAX computes enter and exit on every device and selects
(its SPMD program cannot branch by stage without deadlocking its
collectives); the function computed is the same.

The shared parameters (embedding, final norm, head) are replicated over
``pipe``: a rank's gradient of them is its own stages' part, which the
caller sums over the pipe group (JAX's ``shard_map`` transpose inserts
that ``psum``; ``PipelinedTrainer`` does it after the backward).

Under a ``tensor`` axis (pipe × tensor) each stage's parameters are
DTensors over its tensor group, and the activations that cross the ring
are the plain local values, replicated over ``tensor``: stage s's tensor
rank t exchanges with tensor rank t of stages s ± 1 (the pipe group of
its coordinate). A chunk takes its input as a replicated DTensor and
hands the ring its output's local value; the embedding's output enters
the same way. Under an ``expert`` axis the chunks' experts shard over the
stage's expert group and the layer holds that axis's collectives
(``parallel/moe.py``): the ring carries plain tensors as at pipe alone.

Not copied: the XLA-CPU workarounds (the f32 boundary for half-precision
shared parameters). ``activation_groups`` checkpoints every step, each
one's input kept (the received activation): a recomputed window never
sends again, where JAX recomputes windows of that many steps from their
first carry, collectives included.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.constants import MeshAxis
from dlrover_tpu_torch.parallel.mesh import Mesh


# ---------------------------------------------------------------------------
# the schedule (pure functions: the JAX formulas)
# ---------------------------------------------------------------------------


def schedule_steps(num_micro: int, num_stages: int, num_rounds: int = 1
                   ) -> int:
    """ceil(M/S)·S·C + S − 1: the circular schedule's steps."""
    groups = -(-num_micro // num_stages)
    return groups * num_stages * num_rounds + num_stages - 1


def slot(t: int, stage: int, num_micro: int, num_stages: int,
         num_rounds: int = 1) -> Tuple[int, int, bool]:
    """(round r, microbatch m, valid) of ``stage`` at step ``t``: with
    ts = t − stage, r = (ts // S) % C, m = (ts // (S·C))·S + ts % S,
    valid iff ts ≥ 0 and m < M."""
    s, c = num_stages, num_rounds
    ts = t - stage
    r = (ts // s) % c
    m = (ts // (s * c)) * s + ts % s
    return r, m, ts >= 0 and m < num_micro


def enters(t: int, stage: int, num_micro: int, num_stages: int,
           num_rounds: int = 1) -> bool:
    """Stage 0 injects microbatch m (its embedding) at round 0."""
    r, _, valid = slot(t, stage, num_micro, num_stages, num_rounds)
    return valid and stage == 0 and r == 0


def exits(t: int, stage: int, num_micro: int, num_stages: int,
          num_rounds: int = 1) -> bool:
    """The last stage finishes microbatch m (its loss) at round C − 1."""
    r, _, valid = slot(t, stage, num_micro, num_stages, num_rounds)
    return valid and stage == num_stages - 1 and r == num_rounds - 1


def sends(t: int, stage: int, num_micro: int, num_stages: int,
          num_rounds: int = 1) -> bool:
    """Step t's output goes on to the next stage: every valid step but
    an exit. Stage (s + 1) % S receives it at step t + 1."""
    valid = slot(t, stage, num_micro, num_stages, num_rounds)[2]
    return valid and not exits(t, stage, num_micro, num_stages, num_rounds)


def receives(t: int, stage: int, num_micro: int, num_stages: int,
             num_rounds: int = 1) -> bool:
    """Step t's input came from the previous stage: every valid step but
    an enter."""
    valid = slot(t, stage, num_micro, num_stages, num_rounds)[2]
    return valid and not enters(t, stage, num_micro, num_stages, num_rounds)


# ---------------------------------------------------------------------------
# the ring and its autograd functions
# ---------------------------------------------------------------------------


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor activation's local value (what the ring
    carries); a tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    if not all(p.is_replicate() for p in t.placements):
        raise ValueError(f"a pipeline activation must be replicated, got "
                         f"{t.placements}")
    return t.to_local()


class _Ring:
    """This rank's neighbours on the pipe group and the activation's
    shape, for the shifts."""

    def __init__(self, mesh: Mesh, axis: str, like: torch.Tensor):
        self.group = mesh.submesh([axis]).get_group()
        size, stage = mesh.shape[axis], mesh.coordinate()[axis]
        self.next = dist.get_global_rank(self.group, (stage + 1) % size)
        self.prev = dist.get_global_rank(self.group, (stage - 1) % size)
        self.shape, self.dtype, self.device = like.shape, like.dtype, \
            like.device

    def exchange(self, out: Optional[torch.Tensor], to: int,
                 receive: bool, frm: int) -> torch.Tensor:
        """Send ``out`` (when given) to rank ``to`` and receive a tensor
        from rank ``frm`` (when ``receive``), both posted together;
        zeros when nothing is received."""
        buf = (torch.empty(self.shape, dtype=self.dtype, device=self.device)
               if receive else None)
        ops = []
        if out is not None:
            ops.append(dist.P2POp(dist.isend, out.contiguous(), to,
                                  self.group))
        if receive:
            ops.append(dist.P2POp(dist.irecv, buf, frm, self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if buf is None:
            buf = torch.zeros(self.shape, dtype=self.dtype,
                              device=self.device)
        return buf


class _Shift(torch.autograd.Function):
    """y → the activation of the next step: y to stage s+1 when ``send``,
    the previous stage's y when ``recv``; the backward sends the received
    activation's gradient back and receives y's."""

    @staticmethod
    def forward(ctx, y, ring: _Ring, send: bool, recv: bool):
        ctx.ring, ctx.sent, ctx.received = ring, send, recv
        return ring.exchange(y.detach() if send else None, ring.next, recv,
                             ring.prev)

    @staticmethod
    def backward(ctx, grad):
        ring = ctx.ring
        dy = ring.exchange(grad if ctx.received else None, ring.prev,
                           ctx.sent, ring.next)
        return dy, None, None, None


class _Enter(torch.autograd.Function):
    """The fresh microbatch in place of the ring's activation, whose
    gradient is zero: the shift that delivered it runs its backward."""

    @staticmethod
    def forward(ctx, act, fresh):
        return fresh.clone()

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad), grad


class _Anchor(torch.autograd.Function):
    """A zero scalar depending on the last step's output, so the loss's
    backward reaches every shift of the chain."""

    @staticmethod
    def forward(ctx, y):
        ctx.shape, ctx.dtype = y.shape, y.dtype
        return torch.zeros((), dtype=torch.float32, device=y.device)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros(ctx.shape, dtype=ctx.dtype, device=grad.device)


class _Broadcast(torch.autograd.Function):
    """The last stage's value on every pipe rank; its gradient is the
    ranks' mean (each rank differentiating the same function of it gets
    that one function's gradient)."""

    @staticmethod
    def forward(ctx, x, group, src: int):
        ctx.group = group
        out = x.detach().clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad / dist.get_world_size(ctx.group), None, None


# ---------------------------------------------------------------------------
# the schedule's runner
# ---------------------------------------------------------------------------


def _run(mesh: Mesh, axis: str, num_micro: int, num_rounds: int,
         like: torch.Tensor, compute: Callable) -> torch.Tensor:
    """Every step of this rank's stage: ``compute(act, r, m)`` at a
    valid step (its output the step's y), the input passed through at an
    invalid one, then the shift. Returns the last step's output (for the
    anchor)."""
    size, stage = mesh.shape[axis], mesh.coordinate()[axis]
    steps = schedule_steps(num_micro, size, num_rounds)
    ring = _Ring(mesh, axis, like) if size > 1 else None
    # the chain's first link requires a gradient, so every shift does
    act = torch.zeros_like(like).requires_grad_()
    y = act
    for t in range(steps):
        r, m, valid = slot(t, stage, num_micro, size, num_rounds)
        y = compute(act, r, m) if valid else act
        if t == steps - 1:
            break
        if ring is None:
            act = y
        else:
            act = _Shift.apply(
                y, ring, sends(t, stage, num_micro, size, num_rounds),
                receives(t + 1, stage, num_micro, size, num_rounds))
    return y


def pipeline_train(
    mesh: Mesh,
    chunk_fn: Callable[[Any, torch.Tensor], Any],
    chunk_params: Sequence[Any],
    shared_params: Any,
    enter_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    exit_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    tokens: torch.Tensor,
    targets: torch.Tensor,
    num_rounds: int = 1,
    axis: str = MeshAxis.PIPE,
    remat: bool = False,
    chunk_has_aux: bool = False,
    activation_groups: int = 0,
) -> torch.Tensor:
    """Circular (interleaved) pipeline producing the mean microbatch loss
    (JAX's ``pipeline_train``; see the module docstring).

    ``chunk_params``: this rank's C chunks in round order (chunk r·S + s
    at index r; ``local_chunks`` cuts them from JAX-layout stacked
    leaves); ``chunk_fn(params, act) -> act`` (``(act, aux)`` when
    ``chunk_has_aux``: MoE router losses, summed over every valid step and
    added as their microbatch mean). ``enter_fn(shared, tokens_micro) ->
    (micro, seq, H)``; ``exit_fn(shared, act, targets_micro) -> (micro,)``
    per-row losses. ``tokens``/``targets``: (M, micro, seq), this rank's
    rows. ``remat``: each chunk call checkpointed; ``activation_groups``
    > 0: every step checkpointed (see the module docstring).

    Returns mean(loss rows)/M (+ aux/M), the same value on every pipe
    rank; its gradient is this rank's part of the function (its chunks,
    and the shared parameters its enter or exit touched)."""
    size = mesh.shape[axis]
    stage = mesh.coordinate()[axis]
    num_micro = tokens.shape[0]
    if len(chunk_params) != num_rounds:
        raise ValueError(f"{len(chunk_params)} chunks for {num_rounds} "
                         f"rounds")
    fn = chunk_fn
    if remat:
        def fn(params, x):
            return checkpoint(chunk_fn, params, x, use_reentrant=False)
    tensor_mesh = (mesh.submesh([MeshAxis.TENSOR])
                   if mesh.device_mesh is not None
                   and mesh.shape[MeshAxis.TENSOR] > 1 else None)

    def replicated(t):
        """A ring activation as a chunk's replicated input."""
        if tensor_mesh is None:
            return t
        return DTensor.from_local(t, tensor_mesh, [Replicate()],
                                  run_check=False)

    # the activation's shape and dtype: one enter without a graph (JAX's
    # eval_shape)
    with torch.no_grad():
        like = _plain(enter_fn(shared_params, tokens[0]))
    loss_rows = torch.zeros(tokens.shape[1], dtype=torch.float32,
                            device=like.device)
    aux_acc = torch.zeros((), dtype=torch.float32, device=like.device)
    final = num_rounds - 1

    def compute(act, r, m):
        """One step's (y, loss rows or None, aux or None)."""
        if stage == 0 and r == 0:
            x = _Enter.apply(act, _plain(enter_fn(shared_params,
                                                  tokens[m])))
        else:
            x = act
        y, aux = fn(chunk_params[r], replicated(x)), None
        if chunk_has_aux:
            y, aux = y
        rows = (exit_fn(shared_params, y, targets[m]).float()
                if stage == size - 1 and r == final else None)
        return _plain(y), rows, aux

    bound = bool(activation_groups) and schedule_steps(
        num_micro, size, num_rounds) > activation_groups

    def step(act, r, m):
        nonlocal loss_rows, aux_acc
        if bound:
            y, rows, aux = checkpoint(compute, act, r, m,
                                      use_reentrant=False)
        else:
            y, rows, aux = compute(act, r, m)
        if rows is not None:
            loss_rows = loss_rows + rows
        if aux is not None:
            aux_acc = aux_acc + aux.float()
        return y

    last = _run(mesh, axis, num_micro, num_rounds, like, step)
    local = loss_rows.mean() / num_micro
    if chunk_has_aux:
        local = local + aux_acc / num_micro
    local = local + _Anchor.apply(last)
    if size == 1:
        return local
    total = local.detach().clone()
    dist.all_reduce(total, group=mesh.submesh([axis]).get_group())
    return local + (total - local.detach())


def pipeline_apply(
    mesh: Mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    inputs: torch.Tensor,
    axis: str = MeshAxis.PIPE,
    remat: bool = False,
) -> torch.Tensor:
    """Run ``inputs`` (M, micro, ...) through the pipeline: each rank
    applies ``stage_fn(params, x) -> y`` (y.shape == x.shape) with its
    stage's slice of ``stacked_params`` (leaves with a leading stage dim
    of the pipe size). Every rank returns the (M, micro, ...) outputs.

    JAX's version stores the stream round-robin over the stages and moves
    it through an input and an output ring (M + 2S − 3 steps), so each
    device holds O(M/S) microbatches; here every rank is given the whole
    stream, the last stage keeps the outputs and broadcasts them, and the
    schedule is the circular one at one round (M + S − 1 steps)."""
    size = mesh.shape[axis]
    stage = mesh.coordinate()[axis]
    num_micro = inputs.shape[0]
    params = pytree.tree_map(lambda p: p[stage], stacked_params)
    fn = stage_fn
    if remat:
        def fn(params, x):
            return checkpoint(stage_fn, params, x, use_reentrant=False)
    outs: List[Optional[torch.Tensor]] = [None] * num_micro

    def compute(act, r, m):
        x = _Enter.apply(act, inputs[m]) if stage == 0 else act
        y = fn(params, x)
        if stage == size - 1:
            outs[m] = y
        return y

    last = _run(mesh, axis, num_micro, 1, inputs[0], compute)
    anchor = _Anchor.apply(last).to(inputs.dtype)
    if size == 1:
        return torch.stack(outs) + anchor
    local = (torch.stack(outs) if stage == size - 1
             else torch.zeros_like(inputs)) + anchor
    group = mesh.submesh([axis]).get_group()
    return _Broadcast.apply(local, group,
                            dist.get_global_rank(group, size - 1))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def stack_stage_params(per_stage_params: Sequence[Any]) -> Any:
    """[stage0_tree, stage1_tree, ...] → one tree with a leading stage
    dim."""
    return pytree.tree_map(lambda *leaves: torch.stack(leaves),
                           *per_stage_params)


def local_chunks(stacked: Any, stage: int) -> List[Any]:
    """JAX-layout chunk leaves (C, S, layers_per_chunk, ...) → this
    stage's C chunks in round order, each a tree of (layers_per_chunk,
    ...) leaves (chunk r·S + stage at index r)."""
    rounds = pytree.tree_leaves(stacked)[0].shape[0]
    return [pytree.tree_map(lambda p: p[r, stage], stacked)
            for r in range(rounds)]


def sequential_oracle(stage_fn, per_stage_params, inputs) -> torch.Tensor:
    """Reference semantics: every microbatch through every stage in
    order (what the pipeline must equal)."""
    outs = []
    for i in range(inputs.shape[0]):
        x = inputs[i]
        for params in per_stage_params:
            x = stage_fn(params, x)
        outs.append(x)
    return torch.stack(outs)
