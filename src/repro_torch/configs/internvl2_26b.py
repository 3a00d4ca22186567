"""internvl2-26b [vlm]: InternViT frontend (STUB per assignment) +
InternLM2-20B backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. [arXiv:2404.16821; hf]
input_specs() supplies precomputed patch embeddings (256 tokens)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    activation="silu_glu", rope_theta=1_000_000.0,
    num_image_tokens=256, frontend="vision",
)
