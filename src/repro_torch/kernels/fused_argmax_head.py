"""Wrappers of the CUDA fused argmax head and the speculative verify head
(``csrc/fused_argmax_head.cu``).

Replaces the TPU kernel
``repro.kernels.fused_argmax_head.fused_argmax_head_with_value`` (Pallas,
``pallas_call`` at fused_argmax_head.py:106): ``(argmax_v, max_v)`` of
``h @ w`` with the (B, V) logits never stored, the lowest index winning
ties.

Bound on the H100: memory -- one read of the head weight (V * D * 2
bytes in bf16; 311 MB for qwen3-0.6b) at B multiply-adds per weight.
bf16 runs a tensor-core tile (route ``"wgmma"``): one persistent block
per SM takes a range of whole 64-id vocabulary tiles and a group of up to
64 rows, streams W through a ring of shared-memory tiles by ``cp.async``,
multiplies each with one warpgroup's ``wgmma`` and keeps a running (max,
idx) per row, so W is read once per 64 rows (once at B 8, and once for
the verify head's 64 rows at B 8, T 8).  f32
stays on the CUDA cores (route ``"cuda-core"``), h rows staged in shared
memory.  A second small kernel reduces the per-block partials in block
order, with no atomics.  ``head_plan`` sets every launch parameter from
shapes only; ``ref.argmax_head_split`` is its plain model.

The kernel reads the tied ``(V, D)`` embedding in place: ``w`` is the
``(D, V)`` head weight of the JAX contract, accepted only as the ``.T``
view of a contiguous ``(V, D)`` tensor, which is what
``lm.lm_head_weight`` returns for tied embeddings and for an untied
``lm_head`` after ``weights.cast_params``.

``fused_verify_head`` replaces the TPU kernel
``repro.kernels.fused_topk_head.fused_verify_head`` (:170): the same
argmax pass over the flattened (B*T, D) position rows, then a reduce
kernel that also counts each row's accepted draft run on the card.  A
row's (val, idx) is the same bits whether it is alone, anywhere in a
batch, or a position of the verify head.

``fused_argmax_head_with_value.launches`` and
``fused_verify_head.launches`` count the calls that launched each
kernel pair.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The tensor-core tile of csrc/fused_argmax_head.cu (kVT, kKS, kNR, kStages)
VOCAB_TILE = 64             # vocabulary ids per tile (the wgmma's M)
K_SLAB = 128                # K elements per staged W row
ROW_GROUP = 64              # h rows per block (the padded tile width, N)
STAGES = 5                  # depth of the shared-memory ring
# a stage holds the W and h tiles, bf16; + 1 KB to align the ring
TILE_SMEM_BYTES = STAGES * (VOCAB_TILE + ROW_GROUP) * K_SLAB * 2 + 1024
# The CUDA-core routes: vocabulary ranges per SM, rows staged per block
SPLITS_PER_SM = 4
ROW_BLOCKS = (8, 4, 2, 1)
# The H100 SXM: SMs and opt-in shared memory per block (the defaults of the
# plans, for the tests; on the card the wrappers read the device's own)
H100_SMS = 132
H100_SMEM_OPTIN = 232448
# The most static shared memory a pass-1 kernel keeps beside its dynamic
# shared memory (the tensor-core tile's merge: 2 KB); the plans leave it
STATIC_SMEM = 2048


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """The launch of a head's pass 1: ``nsplit`` vocabulary ranges of
    ``split_ids`` ids each (the last ones may hold fewer, or none), rows
    in ``row_blocks`` blocks of ``row_block``, ``smem_bytes`` of dynamic
    shared memory per block, on ``route`` ``"wgmma"`` (bf16, tensor
    cores) or ``"cuda-core"`` (f32)."""

    route: str
    nsplit: int
    split_ids: int
    row_block: int
    row_blocks: int
    smem_bytes: int


def staged_bytes(d: int, bt: int, element_size: int) -> int:
    """Shared memory ``head::stage_h`` fills for ``bt`` rows of width
    ``d`` (csrc/head_tile.cuh ``staged_floats``): f32, D rounded up to
    32 lanes of 16-byte loads."""
    vec = 16 // element_size
    return -(-d // (32 * vec)) * vec * bt * 32 * 4


def pick_row_block(rows: int, smem_of, smem_limit: int) -> int:
    """BT of a CUDA-core route: the largest of {8, 4, 2, 1}, at most
    ``rows`` (1 always qualifies), whose ``smem_of(bt)`` bytes of dynamic
    shared memory fit ``smem_limit`` less ``STATIC_SMEM``.  Raises when
    not even one row fits."""
    for bt in ROW_BLOCKS:
        if (bt <= rows or bt == 1) and \
                smem_of(bt) <= smem_limit - STATIC_SMEM:
            return bt
    raise ValueError(f"one row of h needs {smem_of(1)} bytes of shared "
                     f"memory, more than the card's {smem_limit} less "
                     f"{STATIC_SMEM}")


def vocab_splits(v: int, sm_count: int) -> int:
    """Vocabulary ranges of a CUDA-core pass 1: a few per SM, at least 32
    ids each."""
    return max(1, min(SPLITS_PER_SM * sm_count, v // 32))


def head_plan(h_shape: Sequence[int], v: int, dtype: torch.dtype,
              sm_count: int = H100_SMS,
              smem_limit: int = H100_SMEM_OPTIN) -> HeadPlan:
    """The pass-1 plan of the argmax and verify heads for h of shape
    ``(B, D)`` or ``(B, T, D)`` (both entries call this with their h's
    shape) over V ids.  It depends on the row count B*T only through
    ``row_blocks`` on the ``"wgmma"`` route (and ``row_block`` on the
    f32 one), and on the card through its SM count and shared memory:

    - bf16 (``"wgmma"``): ranges of ceil(tiles / SMs) whole 64-id tiles,
      one block per range and 64-row group; the tile's shared memory is
      the same at every width D.
    - f32 (``"cuda-core"``): ``vocab_splits`` ranges; BT rows per block
      by ``pick_row_block`` within the shared memory."""
    rows, d = math.prod(h_shape[:-1]), h_shape[-1]
    if dtype == torch.bfloat16:
        if TILE_SMEM_BYTES > smem_limit - STATIC_SMEM:
            raise ValueError(f"the head tile needs {TILE_SMEM_BYTES} bytes "
                             f"of shared memory, more than {smem_limit}")
        tiles = -(-v // VOCAB_TILE)
        per = -(-tiles // sm_count)
        return HeadPlan("wgmma", -(-tiles // per), per * VOCAB_TILE,
                        ROW_GROUP, -(-rows // ROW_GROUP), TILE_SMEM_BYTES)
    if dtype != torch.float32:
        raise ValueError(f"dtype {dtype}: need bf16 or f32")
    nsplit = vocab_splits(v, sm_count)
    bt = pick_row_block(rows, lambda n: staged_bytes(d, n, 4), smem_limit)
    return HeadPlan("cuda-core", nsplit, -(-v // nsplit), bt, -(-rows // bt),
                    staged_bytes(d, bt, 4))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fused_argmax_head")
    lib.repro_fused_argmax_head.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.repro_fused_verify_head.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    for fn in (lib.repro_fused_argmax_head, lib.repro_fused_verify_head,
               lib.repro_head_smem_optin):
        fn.restype = ctypes.c_int
    lib.repro_head_smem_optin.argtypes = [ctypes.c_int]
    lib.repro_head_tile_geometry.argtypes = [ctypes.c_void_p]
    lib.repro_head_tile_geometry.restype = None
    return lib


def tile_geometry() -> tuple:
    """(vocab tile, K slab, row group, stages, shared memory bytes) as the
    built kernel has them; must equal this module's copy."""
    out = (ctypes.c_int * 5)()
    _lib().repro_head_tile_geometry(out)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def device_limits(index: int):
    """(SM count, opt-in shared memory per block in bytes) of CUDA device
    ``index``, read once."""
    smem = _lib().repro_head_smem_optin(index)
    if smem <= 0:
        raise RuntimeError(f"cannot read the shared memory limit of CUDA "
                           f"device {index}")
    return torch.cuda.get_device_properties(index).multi_processor_count, smem


def check_head_operands(h: torch.Tensor, w: torch.Tensor):
    """Validate ``h`` (rows, D) and ``w`` (D, V) for the head kernels;
    returns ``w``'s (V, D) row-major storage.  h contiguous; w the ``.T``
    view of a contiguous (V, D) tensor; both CUDA tensors of one dtype
    (bf16 or f32), 16-byte aligned; D a multiple of 8 (bf16) or 4 (f32)
    elements."""
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
    if h.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("h and w must start on a 16-byte boundary")
    return wt


def _plan(h: torch.Tensor, v: int) -> HeadPlan:
    return head_plan(tuple(h.shape), v, h.dtype,
                     *device_limits(h.device.index))


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
    plan = _plan(h, v)
    pval = torch.empty((b, plan.nsplit), dtype=torch.float32,
                       device=h.device)
    pidx = torch.empty((b, plan.nsplit), dtype=torch.int32, device=h.device)
    idx = torch.empty((b,), dtype=torch.int32, device=h.device)
    val = torch.empty((b,), dtype=torch.float32, device=h.device)
    _raise_on(_lib().repro_fused_argmax_head(
        h.data_ptr(), wt.data_ptr(), pval.data_ptr(), pidx.data_ptr(),
        idx.data_ptr(), val.data_ptr(), b, d, v, plan.nsplit,
        plan.split_ids, plan.row_block, DTYPES[h.dtype],
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
    plan = _plan(h, v)
    pval = torch.empty((b * t, plan.nsplit), dtype=torch.float32,
                       device=h.device)
    pidx = torch.empty((b * t, plan.nsplit), dtype=torch.int32,
                       device=h.device)
    ids = torch.empty((b, t), dtype=torch.int32, device=h.device)
    accept = torch.empty((b,), dtype=torch.int32, device=h.device)
    _raise_on(_lib().repro_fused_verify_head(
        h.data_ptr(), wt.data_ptr(), cand.data_ptr(), pval.data_ptr(),
        pidx.data_ptr(), ids.data_ptr(), accept.data_ptr(), b, t, d, v,
        plan.nsplit, plan.split_ids, plan.row_block, DTYPES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream), "fused_verify_head")
    fused_verify_head.launches += 1
    return ids, accept


fused_verify_head.launches = 0
