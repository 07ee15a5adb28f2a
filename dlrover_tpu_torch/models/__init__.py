"""Model families as torch ``nn.Module``s, the JAX package's
``dlrover_tpu/models`` with the same configs and parameter names:

- gpt.py    — nanoGPT-equivalent (LayerNorm, learned positions, GELU MLP)
- llama.py  — LLaMA family (RMSNorm, RoPE, GQA, SwiGLU)
- bert.py   — BERT-family bidirectional encoder (masked LM, post-LN,
  flash attention with causal=False)
- layers.py — the biased Dense, flax's LayerNorm and GELU that GPT and
  BERT share
"""

from dlrover_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
