"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.

qk_norm + GQA, gated SiLU MLP, RoPE. [hf:Qwen/Qwen3-8B family; hf]
head_dim=128 (published Qwen3 head size; 64*128 q-width, kv-width 1024).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936,
    activation="silu_glu", qk_norm=True, rope_theta=1_000_000.0,
)
