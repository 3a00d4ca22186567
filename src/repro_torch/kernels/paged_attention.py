"""Wrapper of the CUDA paged-attention kernel (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``repro.kernels.paged_attention.paged_attention``
(Pallas, ``pallas_call`` at paged_attention.py:219) in all five score
modes of ``core.attn_approx`` -- a template argument of the kernel, as
the mode is a static argument of the Pallas kernel.  The base2 LUT and
the pwl ROM are built here, once per device, by the same functions the
plain version reads (``base2_frac_lut``, ``pwl_lut``).

Bound on the H100: memory -- one read of each row's K/V history, 4*hd
flops per K/V row, far under the card's ~295 flops per byte.  The design
(split-KV decode: one thread block per (row, kv head, group of up to 32
query rows, chunk of the kv positions), GQA-native shared-memory K/V
tiles staged by cp.async, one warp per query row carrying the f32 online
softmax, then a combine kernel that merges the chunks' partials in chunk
order) reads each K/V byte once per row and query group and never
repeats K/V across the heads of a group; the source's header says what
it leaves for later.

``plan_split`` picks the chunks from the shapes alone -- never from
``positions``, which would sync the host on every decode layer -- so
that the grid covers the card's SMs; the partials go to f32 scratch
allocated here.  The chunk count, and so the summation order, depends on
the shapes only: two calls on the same inputs give the same bits.  It
does depend on the batch -- on B and on the table width, which the
longest row sets -- so a row's exact or pseudo output may differ in its
last bits with its batch-mates (the Pallas kernel and the plain version
fold every row from position 0 whatever the batch).

``paged_attention.launches`` counts the calls that launched the kernel,
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
_HEAD_DIMS = (16, 32, 64, 128, 256)
# the C entry's mode numbers
_MODES = {"exact": 0, "base2": 1, "pseudo": 2, "pwl": 3, "maxonly": 4}
# a chunk is a whole number of the kernel's stages (64 or 32 positions)
CHUNK_QUANTUM = 64
# thread blocks per SM the split aims for (a block holds 4-32 warps)
BLOCKS_PER_SM = 4
# modes whose weight cannot be rescaled across chunks: one chunk
UNSPLIT_MODES = ("base2", "pwl")


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("paged_attention").repro_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_split(b: int, hkv: int, groups: int, max_keys: int, mode: str,
               n_sms: int):
    """(n_chunks, chunk_keys) for a call of ``b`` rows, ``hkv`` KV heads
    and ``groups`` query groups (of up to 32 query rows) per (row, KV
    head) over a table of ``max_keys`` = nb * bs positions, on a card of
    ``n_sms`` SMs.  Plain integers in, plain integers out: it reads no
    tensor, so it never waits on the card.

    One chunk for base2 and pwl, and when the unsplit grid already has a
    block per SM; otherwise about ``BLOCKS_PER_SM`` blocks per SM, each
    chunk a multiple of ``CHUNK_QUANTUM`` positions.  n_chunks *
    chunk_keys covers max_keys, and no chunk lies wholly past it."""
    per = -(-max_keys // CHUNK_QUANTUM) * CHUNK_QUANTUM
    base = b * hkv * groups
    if mode in UNSPLIT_MODES or base >= n_sms:
        return 1, per
    want = min(-(-BLOCKS_PER_SM * n_sms // base), per // CHUNK_QUANTUM)
    keys = -(-per // (want * CHUNK_QUANTUM)) * CHUNK_QUANTUM
    return -(-max_keys // keys), keys


def split_for(q: torch.Tensor, k_pool: torch.Tensor,
              block_tables: torch.Tensor, attn_approx: str = "exact"):
    """The (n_chunks, chunk_keys) the wrapper takes for these operands:
    their shapes and q's device's SM count only."""
    hq = q.shape[-2]
    t = q.shape[1] if q.dim() == 4 else 1
    hkv = k_pool.shape[2]
    groups = -(-t * (hq // hkv) // 32)
    return plan_split(q.shape[0], hkv, groups,
                      block_tables.shape[1] * k_pool.shape[1],
                      approx.resolve(attn_approx)[0], _sm_count(q.device))


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
    n_chunks, chunk_keys = split_for(q, k_pool, block_tables, attn_approx)
    part = None
    if n_chunks > 1:      # per chunk and query row: acc[hd], then m, l
        part = torch.empty(b * t * hq * n_chunks * (hd + 2),
                           dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), positions.data_ptr(),
                out.data_ptr(), b, t, hq, hkv, hd, bs,
                block_tables.shape[1], 0 if window is None else window,
                _DTYPES[q.dtype], _MODES[attn_approx],
                None if rom is None else rom.data_ptr(), 1.0 / math.sqrt(hd),
                n_chunks, chunk_keys,
                None if part is None else part.data_ptr(),
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    paged_attention.launches_by_mode[attn_approx] += 1
    return out


paged_attention.launches = 0
paged_attention.launches_by_mode = dict.fromkeys(_MODES, 0)
