"""Sampler protocol: every head variant behind one two-method interface.

Counterpart of ``repro.serve.sampler``:

  head(params, cfg, h)   device-side: (B, D) final hidden -> the compact
                         output the host needs (here: token ids).
  pick(out, row, rng)    host-side: row ``row`` of ``out`` -> a token id.

  Greedy            the reduced unit: argmax of ``h @ W`` through the
                    fused comparator (``ops.fused_argmax_head_with_value``
                    -- the CUDA kernel on the card, its plain version on
                    the CPU).  Zero exp, zero sum, zero divide
                    (Theorem 1).  'reduced' and 'fused' are the same head
                    here; 'sharded' waits for tensor parallelism.
  SoftmaxBaseline   the full softmax unit: f32 logits, softmax, THEN
                    argmax -- the A/B baseline the paper beats.
  TopK, Temperature wait for the fused top-k head kernel and raise.

Samplers are frozen dataclasses, so the engine groups rows by them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serve.params import SamplingParams

# The k-winner comparator's bound (``repro.serve.sampler.MAX_TOP_K``).
MAX_TOP_K = 64


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
    ``torch.matmul``, then softmax, then argmax."""

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        logits = torch.matmul(h.float(),
                              lm.lm_head_weight(params, cfg).float())
        probs = torch.softmax(logits, dim=-1)
        return torch.argmax(probs, dim=-1).to(torch.int32)

    def pick(self, out, row: int, rng=None) -> int:
        return int(out[row])


@dataclasses.dataclass(frozen=True)
class TopK(Sampler):
    """The k-winner comparator bus (``repro.serve.sampler.TopK``)."""
    k: int
    temperature: float = 1.0
    head_mode: str = "reduced"
    sample_k: Optional[int] = None

    def validate(self, cfg: ModelConfig) -> None:
        raise NotImplementedError(
            "top-k sampling waits for the fused top-k head kernel; the port "
            "serves greedy heads only so far")


@dataclasses.dataclass(frozen=True)
class Temperature(Sampler):
    """Full-vocab Gumbel-max sampling
    (``repro.serve.sampler.Temperature``)."""
    temperature: float = 1.0

    def validate(self, cfg: ModelConfig) -> None:
        raise NotImplementedError(
            "temperature sampling is not ported yet; the port serves greedy "
            "heads only so far")


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
