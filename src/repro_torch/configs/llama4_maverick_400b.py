"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, MoE 128 experts top-1 + shared expert, interleaved every other
layer (maverick topology); early-fusion multimodal handled as text backbone.
[hf:meta-llama/Llama-4 family; unverified]
head_dim=128. 24 MoE layers x (128 routed + 1 shared) experts + 24 dense
layers => ~400B total / ~17B active (cfg.param_count() cross-checks)."""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    activation="silu_glu", rope_theta=500_000.0,
    moe=MoESpec(num_experts=128, top_k=1, d_ff_expert=8192,
                shared_expert=True, interleave_step=2),
)
