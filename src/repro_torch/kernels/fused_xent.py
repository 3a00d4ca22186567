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
    nsplit = _os.n_splits(logits.device, b, v)
    part = torch.empty((2, b, nsplit), dtype=torch.float32,
                       device=logits.device)
    loss = torch.empty((b,), dtype=torch.float32, device=logits.device)
    _os.raise_on(_os.lib().repro_fused_xent(
        logits.data_ptr(), lab.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), loss.data_ptr(), b, v, nsplit,
        _os.DTYPES[logits.dtype],
        torch.cuda.current_stream(logits.device).cuda_stream), "fused_xent")
    fused_xent.launches += 1
    return loss


fused_xent.launches = 0
