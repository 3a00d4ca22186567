"""Wrapper of the CUDA fused cross-entropy head (``repro_fused_xent`` in
``csrc/online_softmax.cu``).

Replaces the TPU kernel ``repro.kernels.fused_xent.fused_xent`` (Pallas,
``pallas_call`` at fused_xent.py:75): the per-row loss ``m + log l -
x[label]`` from one pass over the vocabulary, the probabilities never
stored.

Bound on the H100: memory -- one read of the logits.  It runs on the
softmax unit's plan (``online_softmax.unit_plan``: 4,096-element chunks
from V alone, one block per (chunk, row)) and its stats kernel template,
in one launch at any B: the block whose chunk holds a row's label keeps
that logit from the registers it folded, and the last block of the row
to arrive merges the row's partials and writes ``(m + log l) -
x[label]``.  So a row's loss is the same bits alone or in any batch
(``ref.fused_xent_split`` models it on the CPU), and, like
``softmax_stats``, a call inside a CUDA graph capture raises (the row
tickets belong to a stream).

``fused_xent.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import online_softmax as _os


def fused_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy, (B, V), (B,) int -> (B,) f32.

    logits as ``online_softmax.check_rows`` takes them; labels an
    integer CUDA tensor of shape (B,) on the same device.  Each label
    must lie in [0, V): checking would wait on the card, so the kernel
    writes NaN for a row whose label lies outside."""
    _os.check_rows(logits)
    b, v = logits.shape
    if labels.device != logits.device or labels.shape != (b,) \
            or labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"labels must be ({b},) int32 or int64 on "
                         f"{logits.device}; got {tuple(labels.shape)} "
                         f"{labels.dtype} on {labels.device}")
    lab = labels.to(torch.int64).contiguous()
    index = logits.get_device()
    plan = _os._plan(index, logits.dtype, b, v)
    stream = torch._C._cuda_getCurrentRawStream(index)
    # one scratch allocation: loss (B) | pm (B, nsplit) | pl (B, nsplit)
    # | the label logits (B)
    buf = torch.empty((2 * b * (plan.nsplit + 1),), dtype=torch.float32,
                      device=logits.device)
    _os.raise_on(_os.lib().repro_fused_xent(
        logits.data_ptr(), lab.data_ptr(), buf.data_ptr(),
        _os.tickets(index, stream, b), b, v, plan.nsplit,
        _os.DTYPES[logits.dtype], stream), "fused_xent")
    fused_xent.launches += 1
    return buf[:b]


fused_xent.launches = 0
