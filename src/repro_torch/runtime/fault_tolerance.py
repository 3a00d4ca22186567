"""Fault-tolerance runtime (``repro.runtime.fault_tolerance``): the
host-side mechanisms around the train step.

  PreemptionGuard    SIGTERM/SIGINT -> set a flag; the train loop saves a
                     checkpoint and exits cleanly at the next step boundary.
  StragglerMonitor   EMA of step wall-time; flags steps slower than
                     ``threshold`` x EMA (logs and counts).
  StepTimer          wall time of a ``with`` block.
  elastic_reshard    a whole tree re-placed onto a device, or onto a
                     rank's split of a (data, model) mesh (each leaf
                     cut to the rank's slice on the host first) -- the
                     restart path of a checkpoint restored on the host,
                     possibly into another mesh than the one that wrote
                     it.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch.parallel import sharding


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._old = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, decay: float = 0.9,
                 warmup: int = 3, log_fn: Optional[Callable] = print):
        self.threshold = threshold
        self.decay = decay
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.straggler_steps = []
        self.log = log_fn or (lambda *a, **k: None)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step was a straggler."""
        self.n += 1
        is_straggler = False
        if self.ema is not None and self.n > self.warmup:
            if dt > self.threshold * self.ema:
                is_straggler = True
                self.straggler_steps.append(step)
                self.log(f"[straggler] step {step}: {dt:.3f}s vs "
                         f"EMA {self.ema:.3f}s")
        if self.ema is None:
            self.ema = dt
        elif not is_straggler:   # don't poison the EMA with outliers
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return is_straggler


def elastic_reshard(tree, device, *, cfg=None, split=None):
    """The whole ``tree`` (params or a train state, tensors or numpy) with
    every leaf on ``device`` (lists stay lists); with ``split`` (a
    ``parallel.sharding.Split`` of ``cfg``, a rank's cut of the model
    axis) each leaf first cut to the rank's slice
    (``sharding.shard_leaf``), so only the slice moves -- the
    reference's ``device_put`` onto new shardings."""
    def leaf(path, t):
        if split is not None:
            t = sharding.shard_leaf(path, t, cfg, split)
        return torch.as_tensor(t).contiguous().to(device)

    return tree_mod.map_tree(leaf, tree)


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.t0
        return False
