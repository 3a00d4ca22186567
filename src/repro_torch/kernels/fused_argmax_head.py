"""Wrapper of the CUDA fused argmax head (``csrc/fused_argmax_head.cu``).

Replaces the TPU kernel
``repro.kernels.fused_argmax_head.fused_argmax_head_with_value`` (Pallas,
``pallas_call`` at fused_argmax_head.py:106): ``(argmax_v, max_v)`` of
``h @ w`` with the (B, V) logits never stored, the lowest index winning
ties.

Bound on the H100: memory -- one read of the head weight (V * D * 2
bytes in bf16; 311 MB for qwen3-0.6b) at B multiply-adds per weight.
The design splits the vocabulary over every SM with h staged in shared
memory and 16-byte weight loads, then reduces the per-block partials in
a second small kernel, in block order, with no atomics; the source's
header says what it leaves for later.

The kernel reads the tied ``(V, D)`` embedding in place: ``w`` is the
``(D, V)`` head weight of the JAX contract, accepted only as the ``.T``
view of a contiguous ``(V, D)`` tensor, which is what
``lm.lm_head_weight`` returns for tied embeddings and for an untied
``lm_head`` after ``weights.cast_params``.

``fused_argmax_head_with_value.launches`` counts the calls that launched
the kernel pair.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SPLITS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("fused_argmax_head").repro_fused_argmax_head
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_argmax_head_with_value(h: torch.Tensor, w: torch.Tensor):
    """(idx (B,) int32, val (B,) f32) of argmax over ``h @ w``.

    h (B, D) contiguous; w (D, V) as the ``.T`` view of a contiguous
    (V, D) tensor; both CUDA tensors of one dtype (bf16 or f32), D a
    multiple of 8 (bf16) or 4 (f32) elements.  Anything else raises."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"h (B, D) and w (D, V) expected; got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}")
    for name, x in (("h", h), ("w", w)):
        if x.device.type != "cuda" or x.device != h.device:
            raise ValueError(f"{name} must be a CUDA tensor on {h.device}; "
                             f"got {x.device}")
    if h.dtype not in _DTYPES or w.dtype != h.dtype:
        raise ValueError(f"h/w dtypes {h.dtype}/{w.dtype}: need one of "
                         "bf16, f32 for both")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    wt = w.t()                                     # (V, D), in place
    if not wt.is_contiguous():
        raise ValueError("w must be the .T view of a contiguous (V, D) "
                         "tensor (the tied embedding); got strides "
                         f"{w.stride()}")
    b, d = h.shape
    v = wt.shape[0]
    if d % (16 // h.element_size()):
        raise ValueError(f"D={d} must be a multiple of "
                         f"{16 // h.element_size()} for 16-byte loads")
    nsplit = max(1, min(_SPLITS_PER_SM * _sm_count(h.device.index), v // 32))
    pval = torch.empty((b, nsplit), dtype=torch.float32, device=h.device)
    pidx = torch.empty((b, nsplit), dtype=torch.int32, device=h.device)
    idx = torch.empty((b,), dtype=torch.int32, device=h.device)
    val = torch.empty((b,), dtype=torch.float32, device=h.device)
    err = _fn()(h.data_ptr(), wt.data_ptr(), pval.data_ptr(),
                pidx.data_ptr(), idx.data_ptr(), val.data_ptr(), b, d, v,
                nsplit, _DTYPES[h.dtype],
                torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_argmax_head kernel launch failed: CUDA "
                           f"error {err}")
    fused_argmax_head_with_value.launches += 1
    return idx, val


fused_argmax_head_with_value.launches = 0
