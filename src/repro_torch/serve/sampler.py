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
                    here.  On a vocabulary-sharded head (a tensor-parallel
                    rank's weights, ``cfg.shard``) every mode is
                    the distributed unit, 'sharded' by name:
                    ``core.sharded_reduced_head``, the kernel on the
                    rank's slice and one (val, idx) all-gather.
  TopK              the k-winner comparator bus (``ops.fused_topk_head``,
                    through ``core.fused_reduced_topk``) + an O(k) softmax
                    over the survivors on the host, drawn from the
                    request's numpy RNG; on a sharded head
                    ``core.sharded_reduced_topk`` (k pairs a row a rank).
  Temperature       full-vocab Gumbel-max: the head ships the f32 logit
                    row (``f32_logits``: one GEMM, as the JAX package
                    leaves it to XLA), the host adds Gumbel noise and
                    takes the argmax -- still a comparator decision.
  SoftmaxBaseline   the full softmax unit: f32 logits, softmax, THEN
                    argmax -- the A/B baseline the paper beats.

Under tensor parallelism the Temperature and softmax heads need every
logit: ``f32_logits`` all-gathers the ranks' (B, V / ranks) slices, the
O(B * V) traffic the comparator heads replace by O(B * ranks * k).

A ``host_stride`` engine samples with keys instead of numpy streams, as
the JAX package's does:

  sample_device(params, cfg, h, keys)
                         device-side: (R, D) hidden rows + (R, 2) keys
                         (``repro_torch.prng``) -> (R,) int64 token ids,
                         on the card.  This is what the device-resident
                         loop runs every step (``models.api``
                         ``serve_decode_multi``): the sampled id feeds the
                         next trunk step with no host round-trip.
  pick_keyed(out, row, key)
                         the same draw over one row of a head output
                         already computed (the first token after a
                         prefill, the iterations that carry chunk rows),
                         run on the device ``out`` lives on -- the
                         engine hands it the card's copy, so a draw never
                         depends on where it ran.

Keyed draws are a pure function of (request key, emitted-token index):
the engine splits the key of a request whose sampler draws (``draws``)
once per emitted token (row 0 the next key, row 1 this draw's), so
generations do not depend on the stride, the batch or the scheduling.
Samplers are frozen dataclasses, so the engine groups rows by them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.core import reduced_softmax
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serve.params import SamplingParams

# The k-winner comparator's bound (``repro.serve.sampler.MAX_TOP_K``).
MAX_TOP_K = 64


# (B, V) f32 logits of the Temperature and softmax-baseline heads
f32_logits = lm.logits_fn


class Sampler:
    """Base protocol.  Subclasses are frozen dataclasses (hashable)."""

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        """Device-side: (B, D) hidden -> compact head output."""
        raise NotImplementedError

    def pick(self, out, row: int, rng=None) -> int:
        """Host-side: head output row -> token id."""
        raise NotImplementedError

    # whether the keyed forms consume the key (a random draw); a sampler
    # that never draws ignores its keys, so none need splitting for it
    draws = False

    def sample_device(self, params: dict, cfg: ModelConfig,
                      h: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """Device-side: (R, D) hidden rows + (R, 2) keys -> (R,) int64
        token ids.  Samplers that do not draw ignore ``keys`` (None).  A
        sampler without this form cannot ride a ``host_stride`` engine
        (refused at submit)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no device sampling form; "
            "it cannot be used with host_stride")

    def pick_keyed(self, out, row: int, key: torch.Tensor) -> int:
        """Row ``row`` of head output ``out`` -> a token id, drawn with
        ``key`` (2,) by ``sample_device``'s ops, on ``out``'s device."""
        raise NotImplementedError(
            f"{type(self).__name__} has no keyed sampling form; "
            "it cannot be used with host_stride")

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
        if self.head_mode not in ("reduced", "fused", "sharded"):
            raise ValueError(f"Greedy head_mode={self.head_mode!r}: "
                             "expected 'reduced', 'fused' or 'sharded'")

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        w = lm.lm_head_weight(params, cfg)
        sh = _shard(cfg, self.head_mode)
        if sh is not None:
            return reduced_softmax.sharded_reduced_head(
                h, w, sh.group, v_lo=sh.vocab[0])
        idx, _ = ops.fused_argmax_head_with_value(h, w)
        return idx

    def pick(self, out, row: int, rng=None) -> int:
        return int(out[row])

    def sample_device(self, params, cfg, h, keys):
        # deterministic: the comparator output IS the sample
        return self.head(params, cfg, h).long()

    def pick_keyed(self, out, row: int, key) -> int:
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

    def sample_device(self, params, cfg, h, keys):
        return self.head(params, cfg, h).long()

    def pick_keyed(self, out, row: int, key) -> int:
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
        if self.head_mode not in ("reduced", "fused", "sharded"):
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

    @property
    def draws(self) -> bool:
        n = self.k if self.sample_k is None else self.sample_k
        return self.temperature > 0.0 and n > 1

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        w = lm.lm_head_weight(params, cfg)
        sh = _shard(cfg, self.head_mode)
        if sh is not None:
            return reduced_softmax.sharded_reduced_topk(
                h, w, self.k, sh.group, v_lo=sh.vocab[0],
                vocab_size=cfg.vocab_size)
        return reduced_softmax.fused_reduced_topk(h, w, self.k)

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

    def _draw(self, vals: torch.Tensor, idxs: torch.Tensor,
              keys: torch.Tensor) -> torch.Tensor:
        """The keyed draw over the bus: categorical over the first n
        survivors at the temperature, one key per row."""
        if not self.draws:
            return idxs[:, 0].long()
        n = self.k if self.sample_k is None else self.sample_k
        z = (vals[:, :n] / self.temperature).float()
        choice = prng.categorical(keys, z)
        return torch.gather(idxs.long(), 1, choice[:, None])[:, 0]

    def sample_device(self, params, cfg, h, keys):
        return self._draw(*self.head(params, cfg, h), keys)

    def pick_keyed(self, out, row: int, key) -> int:
        vals, idxs = (_row(x, row) for x in out)
        return int(self._draw(vals, idxs, _key_on(key, vals))[0])

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

    @property
    def draws(self) -> bool:
        return self.temperature > 0.0

    def head(self, params: dict, cfg: ModelConfig, h: torch.Tensor):
        return f32_logits(params, cfg, h)

    def pick(self, out, row: int, rng=None) -> int:
        logits = np.asarray(out[row], np.float32)
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        g = rng.gumbel(size=logits.shape)
        return int(np.argmax(logits / self.temperature + g))

    def _draw(self, logits: torch.Tensor,
              keys: torch.Tensor) -> torch.Tensor:
        if not self.draws:
            return torch.argmax(logits, dim=-1)
        # jax.random.categorical IS the Gumbel-max trick: a comparator
        # decision over perturbed logits, no softmax in the sample
        return prng.categorical(keys, logits / self.temperature)

    def sample_device(self, params, cfg, h, keys):
        return self._draw(self.head(params, cfg, h), keys)

    def pick_keyed(self, out, row: int, key) -> int:
        logits = _row(out, row).float()
        return int(self._draw(logits, _key_on(key, logits))[0])


def _shard(cfg: ModelConfig, head_mode: str):
    """The vocabulary shard a comparator head runs on, or None.  Weights
    that are one rank's slice make every mode the distributed unit (a
    local argmax over a slice would be wrong); 'sharded' without them
    raises."""
    sh = cfg.shard
    if sh is None and head_mode == "sharded":
        raise ValueError("head_mode='sharded' needs the weights of a rank "
                         "of a process group (ServeEngine(group=...))")
    return sh


def _row(x, row: int) -> torch.Tensor:
    """Row ``row`` of a head output leaf (a tensor on any device, or a
    host array) as a one-row tensor where it lives."""
    return torch.as_tensor(x[row:row + 1])


def _key_on(key, like: torch.Tensor) -> torch.Tensor:
    """A (2,) key as a (1, 2) int64 batch on ``like``'s device."""
    return torch.as_tensor(key, dtype=torch.int64).to(like.device)[None]


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
