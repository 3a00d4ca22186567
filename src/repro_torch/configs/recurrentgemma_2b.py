"""recurrentgemma-2b (Griffin) [hybrid]: 26L d_model=2560 10H (MQA kv=1,
head_dim=256) d_ff=7680, RG-LRU + local attention window 2048 in a
(rec, rec, attn) 1:2 pattern. [arXiv:2402.19427; hf]
lru_width=2560, conv1d width 4, gated-GeLU MLP, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    activation="gelu_glu", rope_theta=10_000.0,
    attention_window=2048,
    hybrid_pattern=("rec", "rec", "attn"),
    lru_width=2560, tie_embeddings=True,
)
