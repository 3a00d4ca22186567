"""Wrappers of the CUDA fused argmax head and the speculative verify head
(``csrc/fused_argmax_head.cu``).

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

``fused_verify_head`` replaces the TPU kernel
``repro.kernels.fused_topk_head.fused_verify_head`` (:170): the same
argmax pass over the flattened (B*T, D) position rows, then a reduce
kernel that also counts each row's accepted draft run on the card.

``fused_argmax_head_with_value.launches`` and
``fused_verify_head.launches`` count the calls that launched each
kernel pair.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SPLITS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fused_argmax_head")
    lib.repro_fused_argmax_head.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.repro_fused_verify_head.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    for fn in (lib.repro_fused_argmax_head, lib.repro_fused_verify_head):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_head_operands(h: torch.Tensor, w: torch.Tensor):
    """Validate ``h`` (rows, D) and ``w`` (D, V) for the head kernels;
    returns ``w``'s (V, D) row-major storage.  h contiguous; w the ``.T``
    view of a contiguous (V, D) tensor; both CUDA tensors of one dtype
    (bf16 or f32); D a multiple of 8 (bf16) or 4 (f32) elements."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"h (B, D) and w (D, V) expected; got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}")
    for name, x in (("h", h), ("w", w)):
        if x.device.type != "cuda" or x.device != h.device:
            raise ValueError(f"{name} must be a CUDA tensor on {h.device}; "
                             f"got {x.device}")
    if h.dtype not in DTYPES or w.dtype != h.dtype:
        raise ValueError(f"h/w dtypes {h.dtype}/{w.dtype}: need one of "
                         "bf16, f32 for both")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    wt = w.t()                                     # (V, D), in place
    if not wt.is_contiguous():
        raise ValueError("w must be the .T view of a contiguous (V, D) "
                         "tensor (the tied embedding); got strides "
                         f"{w.stride()}")
    if h.shape[1] % (16 // h.element_size()):
        raise ValueError(f"D={h.shape[1]} must be a multiple of "
                         f"{16 // h.element_size()} for 16-byte loads")
    return wt


def n_splits(device: torch.device, v: int) -> int:
    """Vocabulary ranges of pass 1: a few per SM, at least 32 ids each."""
    return max(1, min(_SPLITS_PER_SM * _sm_count(device.index), v // 32))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def fused_argmax_head_with_value(h: torch.Tensor, w: torch.Tensor):
    """(idx (B,) int32, val (B,) f32) of argmax over ``h @ w``.

    h (B, D), w (D, V) as ``check_head_operands`` takes them.  Anything
    else raises."""
    wt = check_head_operands(h, w)
    b, d = h.shape
    v = wt.shape[0]
    nsplit = n_splits(h.device, v)
    pval = torch.empty((b, nsplit), dtype=torch.float32, device=h.device)
    pidx = torch.empty((b, nsplit), dtype=torch.int32, device=h.device)
    idx = torch.empty((b,), dtype=torch.int32, device=h.device)
    val = torch.empty((b,), dtype=torch.float32, device=h.device)
    _raise_on(_lib().repro_fused_argmax_head(
        h.data_ptr(), wt.data_ptr(), pval.data_ptr(), pidx.data_ptr(),
        idx.data_ptr(), val.data_ptr(), b, d, v, nsplit, DTYPES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream), "fused_argmax_head")
    fused_argmax_head_with_value.launches += 1
    return idx, val


fused_argmax_head_with_value.launches = 0


def fused_verify_head(h: torch.Tensor, w: torch.Tensor, cand: torch.Tensor):
    """Speculative verify: (ids (B, T) int32, accept (B,) int32).

    h (B, T, D) contiguous; w (D, V) as for the argmax head; cand (B,
    T-1) int32 contiguous draft ids, -1 past each row's width.  ids[b, t]
    is the argmax of ``h[b, t] @ w``; accept[b] the length of the leading
    run where ``ids[b, :T-1] == cand[b]``, counted on the card."""
    if h.dim() != 3:
        raise ValueError(f"h must be (B, T, D); got {tuple(h.shape)}")
    b, t, d = h.shape
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    wt = check_head_operands(h.view(b * t, d), w)
    if cand.device != h.device or cand.dtype != torch.int32 \
            or tuple(cand.shape) != (b, t - 1) or not cand.is_contiguous():
        raise ValueError(f"cand must be a contiguous ({b}, {t - 1}) int32 "
                         f"tensor on {h.device}; got {tuple(cand.shape)} "
                         f"{cand.dtype} on {cand.device}")
    v = wt.shape[0]
    nsplit = n_splits(h.device, v)
    pval = torch.empty((b * t, nsplit), dtype=torch.float32, device=h.device)
    pidx = torch.empty((b * t, nsplit), dtype=torch.int32, device=h.device)
    ids = torch.empty((b, t), dtype=torch.int32, device=h.device)
    accept = torch.empty((b,), dtype=torch.int32, device=h.device)
    _raise_on(_lib().repro_fused_verify_head(
        h.data_ptr(), wt.data_ptr(), cand.data_ptr(), pval.data_ptr(),
        pidx.data_ptr(), ids.data_ptr(), accept.data_ptr(), b, t, d, v,
        nsplit, DTYPES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream), "fused_verify_head")
    fused_verify_head.launches += 1
    return ids, accept


fused_verify_head.launches = 0
