"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama architecture, untied embeddings. [arXiv:2401.02954]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    source="arXiv:2401.02954",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102_400,
    tie_embeddings=False,
    rope_theta=10_000.0,
))
