"""rwkv6-7b (Finch) [ssm]: 32L d_model=4096, attention-free time-mix with
data-dependent decay, channel-mix d_ff=14336, vocab=65536.
[arXiv:2404.05892; hf]  wkv head size 64 => 64 heads."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    activation="relu_sq",  # rwkv channel-mix uses relu^2
    rwkv_head_size=64,
)
