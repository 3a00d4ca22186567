"""Wrappers of the CUDA full-softmax unit (``csrc/online_softmax.cu``).

Replace the TPU kernels of ``repro.kernels.online_softmax`` (Pallas):
``softmax_stats`` (``pallas_call`` at online_softmax.py:82), the per-row
``(max, sum exp(x - max))`` by one online pass, and ``online_softmax``
(``pallas_call`` at :121), which normalises ``exp(x - m) / l`` with those
stats -- the paper's baseline unit, two phases as on the TPU.

Bound on the H100: memory -- phase 1 reads x once, phase 2 reads it again
and writes the f32 probabilities once.  Phase 1 splits each row's
vocabulary over enough blocks to cover every SM and merges the per-block
``(m, l)`` partials in split order in a second small kernel
(deterministic, no atomics); the source's header says what it leaves for
later.

``softmax_stats.launches`` and ``online_softmax.launches`` count the
calls that launched each wrapper's kernels; ``online_softmax`` runs its
phase 1 through ``softmax_stats``, so each of its calls adds one to both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SPLITS_PER_SM = 4
_MIN_SPLIT = 1024           # elements a phase-1 block folds at least


@functools.lru_cache(maxsize=None)
def lib():
    so = _build.load("online_softmax")
    so.repro_softmax_stats.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    so.repro_softmax_normalize.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    so.repro_fused_xent.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (so.repro_softmax_stats, so.repro_softmax_normalize,
               so.repro_fused_xent):
        fn.restype = ctypes.c_int
    return so


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_rows(x: torch.Tensor) -> None:
    """x must be a contiguous (B, V) CUDA tensor of f32, bf16 or f16
    with B >= 1 and V >= 1 (any row count: the kernels stride over rows
    past grid.y's 65,535)."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor; got {x.device}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (B, V) with B, V >= 1; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x dtype {x.dtype}: need one of f32, bf16, f16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def n_splits(device: torch.device, b: int, v: int) -> int:
    """Phase-1 blocks per row: a few per SM over the B rows together, at
    least ``_MIN_SPLIT`` elements each."""
    want = -(-_SPLITS_PER_SM * _sm_count(device.index) // b)
    return max(1, min(want, v // _MIN_SPLIT))


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def softmax_stats(x: torch.Tensor):
    """(m (B,) f32, l (B,) f32): the row max and ``sum exp(x - m)``.
    x as ``check_rows`` takes it; anything else raises."""
    check_rows(x)
    b, v = x.shape
    nsplit = n_splits(x.device, b, v)
    part = torch.empty((2, b, nsplit), dtype=torch.float32, device=x.device)
    m = torch.empty((b,), dtype=torch.float32, device=x.device)
    l = torch.empty((b,), dtype=torch.float32, device=x.device)
    raise_on(lib().repro_softmax_stats(
        x.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), m.data_ptr(),
        l.data_ptr(), b, v, nsplit, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream), "softmax_stats")
    softmax_stats.launches += 1
    return m, l


softmax_stats.launches = 0


def online_softmax(x: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis, (B, V) -> (B, V) f32: phase 1
    (``softmax_stats``), then ``exp(x - m) / l``.  x as ``check_rows``
    takes it; anything else raises."""
    m, l = softmax_stats(x)
    b, v = x.shape
    out = torch.empty((b, v), dtype=torch.float32, device=x.device)
    raise_on(lib().repro_softmax_normalize(
        x.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), b, v,
        DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream),
        "online_softmax")
    online_softmax.launches += 1
    return out


online_softmax.launches = 0
