"""xlstm-125m [ssm]: 12 blocks d_model=768 4H vocab=50304, alternating
sLSTM + mLSTM blocks (d_ff=0: blocks carry their own up-projections).
[arXiv:2405.04517]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    tie_embeddings=True,
    xlstm_pattern=("mlstm", "slstm"),
    ssm_expand=2,
))
