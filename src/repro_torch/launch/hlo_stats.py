"""Roofline accounting of a walk on the ``meta`` device.

Counterpart of ``repro.launch.hlo_stats``, under its name so a reader
finds it.  PyTorch has no HLO to read: the reference costs a compiled
program (``cost_analysis``' FLOPs and bytes accessed, the collectives'
result shapes in its text); the port counts the ops a rank's step
actually dispatches while it runs on ``meta`` tensors (``Counter``):

  flops   ``torch.utils.flop_counter.FlopCounterMode`` over every aten
          op, plus the hand kernels' registered formulas
          (``kernels.meta``: their plain versions' FLOPs);
  bytes   per op, its tensor inputs read once and its outputs written
          once (XLA's "bytes accessed" per op); view ops and
          allocations move nothing and count nothing;
  peak    the most bytes the storages made inside the walk held at
          once: each storage counted once, whatever views share it, and
          alive while any tensor holds it -- those autograd saves for
          the backward too.

Collective bytes are not seen by the dispatcher: the walk runs over
``parallel.comm.CountingGroup`` stand-ins, whose ``bytes`` by kind
``RooflineTerms`` carries beside.

Hardware constants: NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit,
from the data sheet -- dense bf16 tensor-core peak 989 TFLOP/s, HBM3
3.35 TB/s (the rates behind ``PERF.md`` §6's bound rule), NVLink
900 GB/s aggregate a card for the collective term.
No chip run has measured the collective link yet: the port's
multi-rank runs on one card go over gloo through the host, which is
bound by the host and says nothing of NVLink.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12       # bf16 dense FLOP/s a card
HBM_BW = 3.35e12          # bytes/s a card
NVLINK_BW = 900e9         # bytes/s a card, NVLink aggregate
H100_HBM = 80 * 10 ** 9   # bytes of device memory ("80 GB")

_aten = torch.ops.aten
# ops that make a tensor without writing it
_ALLOC = {_aten.empty.memory_format, _aten.empty_strided.default,
          _aten.empty_like.default, _aten.new_empty.default,
          _aten.new_empty_strided.default}
# ops that change metadata only, though their schema names no alias
_FREE = _ALLOC | {_aten._unsafe_view.default, _aten.lift_fresh.default,
                  _aten.detach.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Meter(TorchDispatchMode):
    """The bytes and storages half of ``Counter``."""

    def __init__(self, counter: "Counter"):
        super().__init__()
        self.c = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = {id(t): t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if func not in _FREE and not func.is_view:
            self.c.bytes += sum(map(_nbytes, ins.values())) \
                + sum(map(_nbytes, outs))
        held = {t.untyped_storage()._cdata for t in ins.values()}
        for t in outs:
            self.c._hold(t.untyped_storage(), held)
        return out


class Counter:
    """``with Counter() as c:`` -- the FLOPs, bytes and peak of every op
    run inside on ``meta`` tensors (see the module docstring).
    ``c.live`` is the bytes of the storages made inside and alive now,
    ``c.peak`` the most they held at once."""

    def __init__(self):
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._flops = FlopCounterMode(display=False)

    def __enter__(self) -> "Counter":
        self._flops.__enter__()
        self._meter = _Meter(self)
        self._meter.__enter__()
        return self

    def __exit__(self, *exc):
        self._meter.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    def _hold(self, storage, held: set) -> None:
        key = storage._cdata
        if key in held or key in self._storages:
            return                      # an input's, or counted already
        n = storage.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)


@dataclasses.dataclass
class RooflineTerms:
    """One walk's per-rank cost; ``coll_breakdown`` the counting groups'
    bytes by kind (``comm.Group.bytes``' kinds)."""

    flops: float                 # per rank
    bytes_hbm: float             # per rank
    bytes_coll: float            # per rank
    coll_breakdown: Dict[str, int]

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.bytes_coll / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def scaled(self, factor: float) -> "RooflineTerms":
        return RooflineTerms(
            self.flops * factor, self.bytes_hbm * factor,
            self.bytes_coll * factor,
            {k: int(v * factor) for k, v in self.coll_breakdown.items()})

    def __add__(self, other: "RooflineTerms") -> "RooflineTerms":
        cb = dict(self.coll_breakdown)
        for k, v in other.coll_breakdown.items():
            cb[k] = cb.get(k, 0) + v
        return RooflineTerms(self.flops + other.flops,
                             self.bytes_hbm + other.bytes_hbm,
                             self.bytes_coll + other.bytes_coll, cb)

    def as_dict(self):
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.bytes_hbm,
            "coll_bytes_per_dev": self.bytes_coll,
            "coll_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "bottleneck": self.bottleneck,
        }


ZERO = RooflineTerms(0.0, 0.0, 0.0, {})


def terms(counter: Counter, coll: Dict[str, int]) -> RooflineTerms:
    """A walk's ``RooflineTerms``: the counter's FLOPs and bytes, and
    ``coll``, the collective bytes by kind its groups counted."""
    coll = {k: int(v) for k, v in coll.items() if v}
    return RooflineTerms(float(counter.flops), float(counter.bytes),
                         float(sum(coll.values())), coll)
