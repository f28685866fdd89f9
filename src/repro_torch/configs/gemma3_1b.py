"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    qk_norm=True,
    tie_embeddings=True,
    sliding_window=512,
    global_every=6,          # 5 local : 1 global
    rope_theta=10_000.0,     # local layers
    global_rope_theta=1_000_000.0,  # global layers (128k context)
))
