"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT vision encoder + mistral-nemo decoder backbone.
The vision frontend (ViT + projector) is a stub, as in the JAX package: the
decoder takes precomputed patch embeddings through ``embeds``.
[hf:mistralai/Pixtral-12B-2409]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    modality="vision",
))
