"""seamless-m4t-medium [audio]: enc-dec, 12L d_model=1024 16H (MHA kv=16)
d_ff=4096 vocab=256206. Audio frontend (mel + conv feature extractor) is a
stub, as in the JAX package: ``encode`` takes precomputed frame embeddings.
[arXiv:2308.11596]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=12,            # decoder layers
    num_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    tie_embeddings=True,
    modality="audio",
    encoder_seq_len=3072,     # frozen source-frame length for decode shapes
))
