"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
expert d_ff=24576 vocab=65536, Mamba+attention 1:7 interleave, MoE 16
experts top-2 every other layer. [arXiv:2403.19887]

At full width one MoE layer's experts are 19.3 GB, so the port serves it
on one card without experts (``num_experts=0``: every FFN the dense
24576-wide MLP); its ``.reduced()`` cut runs with its experts."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    moe_d_ff=24576,
    vocab_size=65_536,
    tie_embeddings=False,
    attn_every=8,            # 1 attention : 7 mamba per super-block
    num_experts=16,
    top_k=2,
    moe_every=2,             # MoE ffn every other layer
    ssm_state_dim=16,
    ssm_expand=2,
))
