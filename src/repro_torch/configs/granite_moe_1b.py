"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) expert
d_ff=512 vocab=49155, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49_155,
    tie_embeddings=True,
    num_experts=32,
    top_k=8,
    num_shared_experts=0,
    moe_every=1,
))
