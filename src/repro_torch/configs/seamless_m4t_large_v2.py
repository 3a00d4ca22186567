"""seamless-m4t-large-v2 [audio]: enc-dec, 24+24L d_model=1024 16H (MHA,
kv=16) d_ff=8192 vocab=256206. [arXiv:2308.11596; hf]
The speech/text modality frontend is a STUB per the assignment:
input_specs() supplies precomputed frame embeddings to the encoder.
head_dim=64, ReLU FFN."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    activation="relu", rope_theta=10_000.0,
    frontend="audio",
)
