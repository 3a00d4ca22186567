"""The paper's own experiments, on the port.

Counterparts of ``benchmarks/table1.py`` (Table I: Theorem 1 over three
input regimes), ``benchmarks/fig23_monotonicity.py`` (Figs 2-3: e^x and
s(x) keep the order of their inputs) and ``examples/classifier_demo.py``
(a 10-class classifier trained with softmax cross-entropy, then deployed
through the full softmax unit and through the reduced unit).  Each runs
on the card unless the caller passes ``device="cpu"``: there the full
softmax unit is the softmax-unit kernel (``ops.online_softmax``) and the
training loss the cross-entropy kernel (``ops.softmax_xent``), on the
CPU their plain versions.

  python -m repro_torch.paper [--device cpu]     # the three CSV lines
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA
    raises, as every entry point of the port does."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the "
            "card (pass device='cpu' to run the plain kernel versions)")
    return device
