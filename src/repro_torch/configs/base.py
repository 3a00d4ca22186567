"""Config system: model configs, input shapes, smoke reductions.

Every assigned architecture gets a ``configs/<id>.py`` exporting ``CONFIG``;
the registry in ``configs/__init__.py`` maps ``--arch`` ids to them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False      # llama4-style always-on shared expert
    interleave_step: int = 1         # every Nth layer is MoE (1 = all layers)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int                    # decoder layers for encdec
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "silu_glu"     # silu_glu|gelu_glu|gelu|relu|squared_relu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoESpec] = None
    attention_window: Optional[int] = None   # sliding-window size (None=full)
    # hybrid (recurrentgemma / griffin): repeating block pattern.
    hybrid_pattern: Optional[Tuple[str, ...]] = None   # e.g. ('rec','rec','attn')
    lru_width: Optional[int] = None
    conv1d_width: int = 4
    # rwkv6
    rwkv_head_size: int = 64
    # encoder-decoder
    n_encoder_layers: int = 0        # >0 => enc-dec; frontend feeds the encoder
    # modality frontends are STUBS per the assignment: input_specs() carries
    # precomputed patch/frame embeddings for these many prefix positions.
    num_image_tokens: int = 0
    frontend: Optional[str] = None   # 'vision' | 'audio' | None
    # MoE execution: 'auto' = gshard einsum for train/prefill, scatter for
    # decode; 'ep' = shard_map expert parallelism; tests may force 'oracle'.
    moe_impl: str = "auto"
    # Context-parallel attention (shard SEQUENCE over 'model' inside the
    # attention block; weights replicated over 'model'). The production fix
    # for head counts that do not divide TP — see EXPERIMENTS.md §Perf.
    seq_parallel_attn: bool = False
    # Pin decode attention to the seq-sharded-cache partial-softmax pattern
    # (prevents GSPMD from all-gathering the KV cache; §Perf).
    decode_shard_constraints: bool = True
    moe_group_size: int = 4096
    # numerics / lowering
    dtype: str = "bfloat16"
    remat: str = "dots"              # none | dots | full
    scan_layers: bool = True
    use_pallas: bool = False
    # Approximate attention (serving): the score function the PAGED
    # decode path runs ('exact' | 'base2' | 'pseudo' | 'pwl' |
    # 'maxonly' — core/attn_approx.py) and an optional sliding-window
    # mask over the paged kv view.  Static modes: being frozen-dataclass
    # fields, they key every jitted serving factory automatically.
    # Distinct from attention_window (an ARCHITECTURE window backed by
    # ring buffers); attn_window is mask-only — the pool still stores
    # the full history, so speculation/rewind/prefix sharing compose.
    attn_approx: str = "exact"
    attn_window: Optional[int] = None
    # Tensor parallelism: on a rank's view of the config
    # (``parallel.sharding.local_config``) the rank's ``sharding.Split``
    # with its process group; None unsharded.  Left out of equality,
    # hashing and repr: it is where the weights live, not what the model is.
    shard: Optional[Any] = dataclasses.field(default=None, compare=False,
                                             repr=False)
    # Whether the arch is sub-quadratic in sequence length (long_500k gate).
    @property
    def subquadratic(self) -> bool:
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attention_window is not None

    @property
    def q_width(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_width(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        glu = self.activation.endswith("_glu")
        mlp_dense = (3 if glu else 2) * d * f

        def attn_params():
            return d * self.q_width + 2 * d * self.kv_width + self.q_width * d \
                + (2 * self.head_dim if self.qk_norm else 0) + 2 * d

        n_attn = per_layer_attn_count(self)
        total = 0
        # attention layers
        total += n_attn * attn_params()
        # mixing layers that are not attention (rwkv time-mix / rg-lru)
        if self.family == "ssm":  # rwkv6
            lw = d
            total += self.n_layers * (4 * d * lw + d * 64 + 64 * d + 3 * d
                                      + 7 * d + lw * d)
        if self.family == "hybrid":
            n_rec = self.n_layers - n_attn
            lw = self.lru_width or d
            total += n_rec * (2 * d * lw + lw * d + self.conv1d_width * lw
                              + 2 * lw * (lw // 16) + 4 * lw + 2 * d)
        # mlp / moe
        if self.moe is None:
            total += self.n_layers * mlp_dense
        else:
            m = self.moe
            n_moe = self.n_layers // m.interleave_step
            n_dense = self.n_layers - n_moe
            expert = (3 if glu else 2) * d * m.d_ff_expert
            total += n_moe * (m.num_experts * expert + d * m.num_experts
                              + (expert if m.shared_expert else 0))
            total += n_dense * mlp_dense
        # encoder stack (self-attn + mlp) + decoder cross-attn
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn_params() + mlp_dense)
            total += self.n_layers * attn_params()  # cross-attention
        # embeddings + head
        total += v * d
        if not self.tie_embeddings:
            total += d * v
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (= total for non-MoE)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        glu = self.activation.endswith("_glu")
        expert = (3 if glu else 2) * self.d_model * m.d_ff_expert
        n_moe = self.n_layers // m.interleave_step
        inactive = n_moe * (m.num_experts - m.top_k) * expert
        return self.param_count() - inactive


def per_layer_attn_count(cfg: ModelConfig) -> int:
    """How many of the n_layers (decoder) layers are attention layers."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid" and cfg.hybrid_pattern:
        pat = cfg.hybrid_pattern
        full, rem = divmod(cfg.n_layers, len(pat))
        return full * pat.count("attn") + sum(
            1 for t in pat[:rem] if t == "attn")
    return cfg.n_layers


# ---------------------------------------------------------------------------
# Input shapes (assigned to every arch)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason). long_500k only for sub-quadratic archs (DESIGN §6)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k dense KV cache is " \
                      "quadratic-cost; skipped per assignment (DESIGN.md §6)"
    return True, ""


# ---------------------------------------------------------------------------
# Smoke reduction: same family, tiny dims, runnable on CPU in seconds
# ---------------------------------------------------------------------------
def smoke_config(cfg: ModelConfig) -> ModelConfig:
    pat = cfg.hybrid_pattern
    n_layers = len(pat) if pat else 2
    changes = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        lru_width=64 if cfg.lru_width else None,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        num_image_tokens=8 if cfg.num_image_tokens else 0,
        attention_window=(16 if cfg.attention_window else None),
        dtype="float32",
        remat="none",
        name=cfg.name + "-smoke",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64)
    if cfg.family == "ssm":
        changes["rwkv_head_size"] = 16
    return dataclasses.replace(cfg, **changes)
