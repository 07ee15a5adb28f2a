"""The small CTR model the port's embedding tests train
(``test_torch_embedding.py``): FIELDS ids a row, their rows
concatenated, a two-layer tower, BCE on 0/1 labels. Torch only, so a
gloo worker imports it without JAX; it holds no tests."""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer import embedding as temb

VOCAB, DIM, FIELDS, HIDDEN, BATCH = 64, 8, 3, 16, 16


class Tower(nn.Module):
    """The JAX test's ``dense_apply`` with its parameter names and
    layouts."""

    def __init__(self, fields=FIELDS, dim=DIM, hidden=HIDDEN):
        super().__init__()
        self.w0 = nn.Parameter(torch.zeros(fields * dim, hidden))
        self.b0 = nn.Parameter(torch.zeros(hidden))
        self.w1 = nn.Parameter(torch.zeros(hidden, 1))
        self.b1 = nn.Parameter(torch.zeros(1))

    def forward(self, emb):
        x = emb.reshape(emb.shape[0], -1)
        return (torch.relu(x @ self.w0 + self.b0) @ self.w1 + self.b1)[:, 0]


def bce(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels.float())


@contextlib.contextmanager
def one_thread():
    """Run the block at one CPU thread, as the gloo ranks run: the CPU
    GEMM's summation order, and so its bits, follow the thread count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def dense_init(seed):
    rng = np.random.default_rng(seed)
    return {"w0": rng.normal(0, 0.3, (FIELDS * DIM, HIDDEN)),
            "b0": rng.normal(0, 0.1, (HIDDEN,)),
            "w1": rng.normal(0, 0.3, (HIDDEN, 1)),
            "b1": np.zeros((1,))}


def batches(seed, n, vocab=VOCAB):
    """``n`` (ids, labels) batches; the ids come from the lower half of
    the table only, so its upper rows are never touched."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab // 2, (BATCH, FIELDS), dtype=np.int32),
             rng.integers(0, 2, (BATCH,)).astype(np.float32))
            for _ in range(n)]


def port_state(mesh=None, seed=0):
    """(trainer, state) of the port on the CPU: the table from ``seed``,
    the tower at ``dense_init(0)``."""
    mesh = mesh or create_mesh(MeshSpec(), "cpu")
    embedding = temb.ShardedEmbedding(
        temb.EmbeddingConfig(vocab_size=VOCAB, embed_dim=DIM),
        device="cpu", generator=torch.Generator().manual_seed(seed))
    tower = Tower()
    with torch.no_grad():
        for name, value in dense_init(0).items():
            getattr(tower, name).copy_(torch.from_numpy(value))
    trainer = temb.ElasticEmbeddingTrainer(mesh, embedding, tower, bce)
    return trainer, trainer.init()
