"""Sampler protocol: every head variant behind one two-method interface.

Counterpart of ``repro.serve.sampler``:

  head(params, cfg, h)   device-side: (B, D) final hidden -> the compact
                         output the host needs (token ids, the k-winner
                         bus, or a logit row).
  pick(out, row, rng)    host-side: row ``row`` of ``out`` -> a token id.

  Greedy            the reduced unit: argmax of ``h @ W`` through the
                    fused comparator (``ops.fused_argmax_head_with_value``
                    -- the CUDA kernel on the card, its plain version on
                    the CPU).  Zero exp, zero sum, zero divide
                    (Theorem 1).  'reduced' and 'fused' are the same head
                    here; 'sharded' waits for tensor parallelism.
  TopK              the k-winner comparator bus (``ops.fused_topk_head``,
                    through ``core.fused_reduced_topk``) + an O(k) softmax
                    over the survivors on the host, drawn from the
                    request's numpy RNG.
  Temperature       full-vocab Gumbel-max: the head ships the f32 logit
                    row (``f32_logits``: one GEMM, as the JAX package
                    leaves it to XLA), the host adds Gumbel noise and
                    takes the argmax -- still a comparator decision.
  SoftmaxBaseline   the full softmax unit: f32 logits, softmax, THEN
                    argmax -- the A/B baseline the paper beats.

The keyed on-device forms (``sample_device``/``pick_keyed``) wait for
``host_stride``.  Samplers are frozen dataclasses, so the engine groups
rows by them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import reduced_softmax
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serve.params import SamplingParams

# The k-winner comparator's bound (``repro.serve.sampler.MAX_TOP_K``).
MAX_TOP_K = 64


def f32_logits(params: dict, cfg: ModelConfig,
               h: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 logits ``h @ W``, as the JAX package's ``jnp.dot(h, W,
    preferred_element_type=jnp.float32)``.  On the card one GEMM reads
    the bf16 W in place and writes f32 (``aten::mm.dtype``), with no f32
    copy of W (622 MB at qwen3-0.6b's width); on the CPU, where that
    overload has no kernel, ``h.float() @ W.float()``."""
    w = lm.lm_head_weight(params, cfg)
    if h.device.type == "cpu":
        return torch.matmul(h.float(), w.float())
    return torch.mm(h, w, out_dtype=torch.float32)


class Sampler:
    """Base protocol.  Subclasses are frozen dataclasses (hashable)."""

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        """Device-side: (B, D) hidden -> compact head output."""
        raise NotImplementedError

    def pick(self, out, row: int, rng=None) -> int:
        """Host-side: head output row -> token id."""
        raise NotImplementedError

    def validate(self, cfg: ModelConfig) -> None:
        """Raise for configurations this sampler cannot serve."""

    def device_form(self) -> "Sampler":
        """The sampler with host-only fields canonicalized: requests that
        differ only host-side share one head group."""
        return self

    def candidate_ids(self, out, row: int):
        """Ranked candidate token ids for ``row`` when the head ships
        them (the k-winner bus), else None."""
        return None


@dataclasses.dataclass(frozen=True)
class Greedy(Sampler):
    """argmax via the reduced comparator -- the paper's unit."""
    head_mode: str = "reduced"

    def validate(self, cfg: ModelConfig) -> None:
        if self.head_mode == "sharded":
            raise NotImplementedError(
                "head_mode='sharded' is the tensor-parallel head; the port "
                "has no tensor parallelism yet")
        if self.head_mode not in ("reduced", "fused"):
            raise ValueError(f"Greedy head_mode={self.head_mode!r}: "
                             "expected 'reduced', 'fused' or 'sharded'")

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        idx, _ = ops.fused_argmax_head_with_value(
            h, lm.lm_head_weight(params, cfg))
        return idx

    def pick(self, out, row: int, rng=None) -> int:
        return int(out[row])


@dataclasses.dataclass(frozen=True)
class SoftmaxBaseline(Sampler):
    """The full softmax unit: exp + normalize + divide, THEN compare.
    A plain PyTorch baseline, not a kernel: f32 logits from
    ``f32_logits``, then softmax, then argmax."""

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        logits = f32_logits(params, cfg, h)
        probs = torch.softmax(logits, dim=-1)
        return torch.argmax(probs, dim=-1).to(torch.int32)

    def pick(self, out, row: int, rng=None) -> int:
        return int(out[row])


@dataclasses.dataclass(frozen=True)
class TopK(Sampler):
    """k-winner comparator bus + O(k) host softmax over the survivors.

    temperature <= 0 degenerates to the greedy comparator exactly
    (survivor 0 is the argmax, lowest index among ties).

    ``sample_k`` (host-only) draws from the first ``sample_k`` survivors
    while the bus still ships all ``k`` -- how a request asks for top-k
    candidate ids wider than its sampling pool
    (``SamplingParams.n_candidates``); ``sample_k=1`` is exact greedy.
    """
    k: int
    temperature: float = 1.0
    head_mode: str = "reduced"
    sample_k: Optional[int] = None

    def validate(self, cfg: ModelConfig) -> None:
        k_cap = min(MAX_TOP_K, cfg.vocab_size)
        if not 1 <= self.k <= k_cap:
            raise ValueError(
                f"top_k={self.k} out of range [1, {k_cap}] "
                f"(min(MAX_TOP_K={MAX_TOP_K}, vocab_size="
                f"{cfg.vocab_size}))")
        if self.sample_k is not None and not 1 <= self.sample_k <= self.k:
            raise ValueError(f"sample_k={self.sample_k} out of range "
                             f"[1, k={self.k}]")
        if self.head_mode == "sharded":
            raise NotImplementedError(
                "head_mode='sharded' is the tensor-parallel head; the port "
                "has no tensor parallelism yet")
        if self.head_mode not in ("reduced", "fused"):
            # the 'softmax' baseline has no top-k form -- reject rather
            # than silently substituting the reduced path
            raise ValueError(
                f"top_k sampling is not implemented for head_mode="
                f"{self.head_mode!r}; use 'reduced', 'fused' or "
                "'sharded'")

    def device_form(self) -> "Sampler":
        # temperature and sample_k are host-only: requests that differ
        # only there share one head group
        return dataclasses.replace(self, temperature=1.0, sample_k=None)

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        return reduced_softmax.fused_reduced_topk(
            h, lm.lm_head_weight(params, cfg), self.k)

    def pick(self, out, row: int, rng=None) -> int:
        vals, idxs = out
        n = self.k if self.sample_k is None else self.sample_k
        vals = np.asarray(vals[row], np.float32)[:n]
        idxs = np.asarray(idxs[row])[:n]
        if self.temperature <= 0.0 or n == 1:
            return int(idxs[0])
        z = vals / self.temperature
        p = np.exp(z - z.max())
        p /= p.sum()
        return int(rng.choice(idxs, p=p))

    def candidate_ids(self, out, row: int):
        return np.asarray(out[1][row])


@dataclasses.dataclass(frozen=True)
class Temperature(Sampler):
    """Full-vocab sampling via the Gumbel-max trick -- still no softmax.

    The head ships the f32 logit row; the host adds Gumbel noise scaled
    by the temperature and takes the argmax.  argmax(logits/T + G)
    samples exactly softmax(logits/T).  temperature <= 0 degenerates to
    plain argmax (lowest index among ties).  Costs an O(V) device->host
    row per step; prefer TopK when k survivors suffice."""
    temperature: float = 1.0

    def device_form(self) -> "Sampler":
        return dataclasses.replace(self, temperature=1.0)

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        return f32_logits(params, cfg, h)

    def pick(self, out, row: int, rng=None) -> int:
        logits = np.asarray(out[row], np.float32)
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        g = rng.gumbel(size=logits.shape)
        return int(np.argmax(logits / self.temperature + g))


def canonical_order(samplers) -> list:
    """Deterministic ordering of a set of device-form samplers: the fused
    decode step applies one head per distinct ``device_form()`` in this
    order, whatever the slots' arrival order."""
    return sorted(samplers, key=repr)


def resolve(spec: Union[str, Sampler, SamplingParams], top_k: int = 1,
            temperature: float = 1.0, *,
            cfg: Optional[ModelConfig] = None,
            default_head_mode: str = "reduced") -> Sampler:
    """Map a head spec onto a Sampler -- the one string switch.

    ``spec`` is a ``SamplingParams`` (its ``head_mode`` overrides
    ``default_head_mode``), a Sampler (returned as-is, validated), or a
    ``head_mode`` string: 'reduced' | 'fused' | 'sharded' | 'softmax' |
    'temperature'.  ``top_k > 1`` selects the k-winner bus.  Pass ``cfg``
    to validate against the model (unported heads raise there)."""
    if isinstance(spec, SamplingParams):
        p = spec
        mode = p.head_mode if p.head_mode is not None else default_head_mode
        if p.n_candidates == 0:
            return resolve(mode, p.top_k, p.temperature, cfg=cfg)
        if mode not in ("reduced", "fused", "sharded"):
            raise ValueError(
                f"n_candidates={p.n_candidates} needs the k-winner "
                f"comparator bus (head_mode 'reduced', 'fused' or "
                f"'sharded'), not {mode!r}")
        s = TopK(max(p.top_k, p.n_candidates), p.temperature, mode,
                 sample_k=p.top_k)
    elif isinstance(spec, Sampler):
        s = spec
    elif top_k < 1:
        raise ValueError(f"top_k={top_k} out of range [1, "
                         f"{MAX_TOP_K}]: must be >= 1")
    elif spec == "softmax":
        if top_k > 1:
            raise ValueError(
                "top_k sampling is not implemented for head_mode="
                "'softmax'; use 'reduced' or 'fused'")
        s = SoftmaxBaseline()
    elif spec == "temperature":
        if top_k > 1:
            raise ValueError(
                "head_mode='temperature' samples the full vocab; "
                "combine top_k with 'reduced' or 'fused' instead")
        s = Temperature(temperature)
    elif spec in ("reduced", "fused", "sharded"):
        s = (TopK(top_k, temperature, spec) if top_k > 1 else Greedy(spec))
    else:
        raise ValueError(f"unknown head spec {spec!r}")
    if cfg is not None:
        s.validate(cfg)
    return s
