"""Wrapper of the CUDA fused cross-entropy head (``repro_fused_xent`` in
``csrc/online_softmax.cu``).

Replaces the TPU kernel ``repro.kernels.fused_xent.fused_xent`` (Pallas,
``pallas_call`` at fused_xent.py:75): the per-row loss ``m + log l -
x[label]`` from one online pass over the vocabulary, the probabilities
never stored.  Phase 1 is the softmax-stats kernel's; its merge also
reads each row's label logit once.

Bound on the H100: memory -- one read of the logits.

``fused_xent.launches`` counts the calls that launched the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import online_softmax as _os


def fused_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy, (B, V), (B,) int -> (B,) f32.

    logits as ``online_softmax.check_rows`` takes them; labels an
    integer CUDA tensor of shape (B,) on the same device.  Each label
    must lie in [0, V): the kernel reads ``logits[b, labels[b]]`` without
    a check, since checking would wait on the card."""
    _os.check_rows(logits)
    b, v = logits.shape
    if labels.device != logits.device or labels.shape != (b,) \
            or labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"labels must be ({b},) int32 or int64 on "
                         f"{logits.device}; got {tuple(labels.shape)} "
                         f"{labels.dtype} on {labels.device}")
    lab = labels.to(torch.int64).contiguous()
    index = logits.get_device()
    nsplit = _os.n_splits(index, b, v)
    # one scratch allocation: loss (B) | pm (B, nsplit) | pl (B, nsplit)
    buf = torch.empty((b * (2 * nsplit + 1),), dtype=torch.float32,
                      device=logits.device)
    base = buf.data_ptr()
    _os.raise_on(_os.lib().repro_fused_xent(
        logits.data_ptr(), lab.data_ptr(), base + 4 * b,
        base + 4 * b * (nsplit + 1), base, b, v, nsplit,
        _os.DTYPES[logits.dtype],
        torch._C._cuda_getCurrentRawStream(index)), "fused_xent")
    fused_xent.launches += 1
    return buf[:b]


fused_xent.launches = 0
