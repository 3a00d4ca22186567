"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention``
(Pallas, ``pallas_call`` at flash_attention.py:100): causal and
sliding-window attention with native GQA, the (B, Hq, T, S) scores never
stored.  The one-shot prompt prefill runs it once per layer.

Bound on the H100: memory at the served prompt lengths -- one read of q,
k and v and one write of out.  The g query heads of a KV head sit in one
block and share every staged K/V tile.  bf16 (the served dtype) runs on
the tensor cores: 64 query rows per block of 4 warps, S = Q K^T and
O += P V as ``mma.sync`` tiles from double-buffered ``cp.async`` K/V
tiles, the online softmax in registers.  f32 keeps one warp per query
row on the CUDA cores (TF32 would miss f32's tolerance); the source's
header says the rest.

The kernel takes each operand's strides, so the layer passes the
``(B, T, H, hd) -> (B, H, T, hd)`` transposed views without a copy, and
``out`` is allocated in q's memory layout.

``flash_attention.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 192, 256)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("flash_attention").repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, T, hd); k, v (B, Hkv, S, hd): CUDA tensors of one dtype
    (bf16 or f32) on one device, any strides with the head dim
    contiguous and every row on 16 bytes; hd in {16, 32, 64, 128, 192,
    256};
    Hkv | Hq.  Returns (B, Hq, T, hd) in q's dtype and memory layout.
    Anything else raises."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}; "
                             f"got {x.device}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, H, L, hd); got "
                             f"{tuple(x.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                         "one of bf16, f32 for all")
    b, hq, t, hd = q.shape
    _, hkv, s, _ = k.shape
    if hd not in _HEAD_DIMS or k.shape[3] != hd:
        raise ValueError(f"head dim {hd} (k {k.shape[3]}): need one of "
                         f"{_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b:
        raise ValueError(f"k and v must be equal ({b}, Hkv, S, {hd}); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq}, Hkv={hkv}: need Hkv | Hq")
    if window is not None and window < 1:
        raise ValueError(f"window={window}: must be >= 1 or None")
    out = torch.empty_like(q)                  # q's strides when dense
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.stride(3) != 1 or any(st % vec for st in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name}: the head dim must be contiguous and "
                             f"every row start on 16 bytes; got strides "
                             f"{x.stride()}")
    strides = (ctypes.c_longlong * 12)(*(
        st for x in (q, k, v, out) for st in x.stride()[:3]))
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, t, s, hq, hkv, hd, int(bool(causal)),
                0 if window is None else int(window), _DTYPES[q.dtype],
                1.0 / math.sqrt(hd),
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
