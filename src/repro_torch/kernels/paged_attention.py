"""Wrapper of the CUDA paged-attention kernel (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``repro.kernels.paged_attention.paged_attention``
(Pallas, ``pallas_call`` at paged_attention.py:219) in all five score
modes of ``core.attn_approx`` -- a template argument of the kernel, as
the mode is a static argument of the Pallas kernel.  The base2 LUT and
the pwl ROM are built here, once per device, by the same functions the
plain version reads (``base2_frac_lut``, ``pwl_lut``).

Bound on the H100: memory -- one read of each row's K/V history, 4*hd
flops per K/V row, far under the card's ~295 flops per byte.  The design
(split-KV decode: one thread block per (query group, chunk of the kv
positions, kv head, row), K/V tiles staged through the table by cp.async
and shared by the GQA heads of a kv head, then a combine kernel that
merges the chunks' partials in chunk order) reads each K/V byte once per
row and query group.  Two routes, by dtype only: bf16 folds on the
tensor cores (flash attention's ``mma.sync`` tile, the T*g query rows of
a kv head packed into 16-row tiles), f32 one warp per query row on the
CUDA cores.  base2 and pwl weigh every score at its row's max, as the
plain version does: a row-max pre-pass over K, with the fold's own
scores, writes each row's max per chunk; the fold seeds its carry with
the row's max, so no chunk is ever rescaled and the combine is a plain
sum.  The source's header says the rest.

What it leaves on the table: base2 and pwl read K twice and launch three
kernels; the ``mma`` tile's rows past T*g idle (2 of 16 used at a
qwen3-0.6b decode step).

The chunk width is a constant per (dtype, head dim), ``chunk_width``,
in every mode; the chunk count covers the table.  Chunk, stage and
32-key slice edges lie at fixed multiples of absolute position, an empty
chunk weighs nothing in the combine, and one non-empty chunk passes
through it bit for bit.  So a row's attention bits depend on its own
inputs, the dtype, the head dim and the mode only: the same alone or
beside any batch-mates, at T = 1 or inside a wider speculative window
whose padding repeats its position -- as the Pallas kernel and the plain
version, which fold every row from position 0 whatever the batch.  The
plan reads shapes, never ``positions`` (which would sync the host on
every decode layer); the partials and the chunk maxima go to f32 scratch
allocated here.

``paged_attention.launches`` counts the calls that launched the kernel
(a call is up to three launches: pre-pass, fold and combine),
``paged_attention.launches_by_mode`` the same calls by score mode.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core import attn_approx as approx
from repro_torch.core.softmax_variants import base2_frac_lut
from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 192, 256)
# the C entry's mode numbers
_MODES = {"exact": 0, "base2": 1, "pseudo": 2, "pwl": 3, "maxonly": 4}
# a chunk is a whole number of the kernel's stages (64 or 32 positions)
CHUNK_QUANTUM = 64
# modes that weigh at the row's max, after the kernel's row-max pre-pass
PREMAX_MODES = ("base2", "pwl")


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("paged_attention").repro_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _rom(mode: str, device: torch.device) -> Optional[torch.Tensor]:
    """The mode's f32 table on ``device`` (None for a mode without)."""
    if mode == "base2":
        return base2_frac_lut(approx.BASE2_PRECISION_BITS, device)
    if mode == "pwl":
        return approx.pwl_lut(approx.PWL_SEGMENTS, device)
    return None


def chunk_width(dtype: torch.dtype, hd: int) -> int:
    """Positions per chunk for ``dtype`` at head dim ``hd``: 64 (one
    64-position stage) from hd 128 up, and 8192 // hd below, so that a
    chunk holds at least 8,192 K elements (16 KB of K and V in bf16) and
    the partials (hd + 2 floats per query row and chunk) stay small
    against the K/V they summarise.  At qwen3-0.6b's hd 128 a
    1,000-token row takes 16 chunks, so B 1 still spreads over 16 x 8 kv
    heads = 128 blocks on the H100's 132 SMs, and B 8 over 1,024.  Never
    a function of B, T or the table width: chunk edges are fixed
    multiples of it in absolute position."""
    if dtype not in _DTYPES or hd not in _HEAD_DIMS:
        raise ValueError(f"no chunk width for {dtype} at head dim {hd}")
    return max(CHUNK_QUANTUM, 8192 // hd)


def plan_split(max_keys: int, dtype: torch.dtype, hd: int):
    """(n_chunks, chunk_keys) for a table of ``max_keys`` = nb * bs
    positions: ``chunk_width(dtype, hd)`` positions per chunk, in every
    score mode, and as many chunks as cover the table.  Plain integers
    in, plain integers out: it reads no tensor, so it never waits on the
    card."""
    width = chunk_width(dtype, hd)
    return -(-max_keys // width), width


def split_for(q: torch.Tensor, k_pool: torch.Tensor,
              block_tables: torch.Tensor):
    """The (n_chunks, chunk_keys) the wrapper takes for these operands:
    q's dtype and head dim and the table's width in positions."""
    return plan_split(block_tables.shape[1] * k_pool.shape[1], q.dtype,
                      q.shape[-1])


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    positions: torch.Tensor, *,
                    attn_approx: str = "exact",
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, hd) or (B, T, Hq, hd); pools (num_blocks, bs, Hkv, hd);
    block_tables (B, nb) int32; positions (B,) or (B, T) int32, all
    contiguous CUDA tensors, q and pools of one dtype (bf16 or f32);
    ``attn_approx`` one of ``core.attn_approx.VARIANTS``.  Returns q's
    shape and dtype.  Anything else raises."""
    attn_approx, window = approx.resolve(attn_approx, window)
    multi = q.dim() == 4
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (B, Hq, hd) or (B, T, Hq, hd); got "
                         f"{tuple(q.shape)}")
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    t = q.shape[1] if multi else 1
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "positions": positions}
    for name, x in tensors.items():
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}; "
                             f"got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"q/k_pool/v_pool dtypes {q.dtype}/{k_pool.dtype}/"
                         f"{v_pool.dtype}: need one of bf16, f32 for all")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be equal (num_blocks, bs, Hkv, hd); "
                         f"got {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    _, bs, hkv, hd_pool = k_pool.shape
    if hd_pool != hd or hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} (pool {hd_pool}): need one of "
                         f"{_HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"Hq={hq}, Hkv={hkv}: need Hkv | Hq")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be ({b}, nb) int32; got "
                         f"{tuple(block_tables.shape)} {block_tables.dtype}")
    want = (b, t) if multi else (b,)
    if positions.dtype != torch.int32 or tuple(positions.shape) != want:
        raise ValueError(f"positions must be {want} int32; got "
                         f"{tuple(positions.shape)} {positions.dtype}")
    rom = _rom(attn_approx, q.device)
    out = torch.empty_like(q)
    n_chunks, chunk_keys = split_for(q, k_pool, block_tables)
    rows = b * t * hq * n_chunks      # (query row, chunk) pairs
    part = cmax = None
    if n_chunks > 1:      # per chunk and query row: acc[hd], then m, l
        part = torch.empty(rows * (hd + 2), dtype=torch.float32,
                           device=q.device)
    if attn_approx in PREMAX_MODES:   # the pre-pass's chunk maxima
        cmax = torch.empty(rows, dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), positions.data_ptr(),
                out.data_ptr(), b, t, hq, hkv, hd, bs,
                block_tables.shape[1], 0 if window is None else window,
                _DTYPES[q.dtype], _MODES[attn_approx],
                None if rom is None else rom.data_ptr(), 1.0 / math.sqrt(hd),
                n_chunks, chunk_keys,
                None if part is None else part.data_ptr(),
                None if cmax is None else cmax.data_ptr(),
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    paged_attention.launches_by_mode[attn_approx] += 1
    return out


paged_attention.launches = 0
paged_attention.launches_by_mode = dict.fromkeys(_MODES, 0)
