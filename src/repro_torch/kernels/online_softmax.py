"""Wrappers of the CUDA full-softmax unit (``csrc/online_softmax.cu``).

Replace the TPU kernels of ``repro.kernels.online_softmax`` (Pallas):
``softmax_stats`` (``pallas_call`` at online_softmax.py:82), the per-row
``(max, sum exp(x - max))`` by one online pass, and ``online_softmax``
(``pallas_call`` at :121), which normalises ``exp(x - m) / l`` with those
stats -- the paper's baseline unit.  The cross-entropy head
(``fused_xent``) runs on the same plan and kernel template.

Bound on the H100: memory -- softmax_stats reads x once; online_softmax
reads x and writes the f32 probabilities once.  ``unit_plan`` splits each
row into chunks of ``CHUNK`` elements (the split follows V alone, never
B), one block per (chunk, row), and picks the route from shapes only:

- ``softmax_stats`` (and ``fused_xent``): one launch at any B; the last
  block of a row to arrive merges the row's partials in one fixed order
  (a per-row ticket, from a zeroed buffer kept per (device, stream);
  refused inside a CUDA graph capture, whose replays would share the
  capturing stream's tickets with whatever runs on the stream then).
- ``online_softmax``: ``"one-pass"`` where the B * nsplit blocks fit on
  the card at once -- one cooperative launch that reads x once and merges
  each row's partials behind a grid barrier; else ``"two-launch"`` --
  softmax_stats' launch, then a normalize kernel.

Both routes give a row the same bits, alone or in any batch;
``ref.softmax_stats_split`` models the split on the CPU.

``softmax_stats.launches`` counts the launches of its stats kernel:
its own calls, and the first launch of each two-launch
``online_softmax``.  ``online_softmax.launches`` counts that wrapper's
calls, and ``online_softmax.launches_by_route`` the same calls by route.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The chunk kernels' geometry (csrc kThreads, kPerThread, kChunk,
# kMinBlocksPerSM): 256 threads of 16 elements, every dtype
THREADS = 256
PER_THREAD = 16
CHUNK = THREADS * PER_THREAD
MIN_BLOCKS_PER_SM = 4      # their launch bounds' promise
ONE_PASS, TWO_LAUNCH = "one-pass", "two-launch"


@dataclasses.dataclass(frozen=True)
class UnitPlan:
    """The launch of the unit's chunk kernels: rows in ``nsplit`` chunks
    of ``chunk`` elements at absolute multiples of it (the last may hold
    fewer), a thread holding ``vec`` contiguous elements per 16-byte load;
    ``route`` is online_softmax's, ``"one-pass"`` or ``"two-launch"``."""

    route: str
    chunk: int
    nsplit: int
    vec: int


def unit_plan(dtype: torch.dtype, b: int, v: int,
              resident_blocks: int) -> UnitPlan:
    """The plan for x (b, v) of ``dtype``: the chunk from the dtype alone
    (``CHUNK`` elements, 16 KB of f32, 8 KB of bf16 or f16), ``nsplit =
    ceil(v / chunk)`` from V alone, and the one-pass route exactly when
    the ``b * nsplit`` blocks fit in ``resident_blocks``, the blocks of
    the one-pass kernel the card holds at once (the wrappers pass
    ``device_resident_blocks``)."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype}: need one of f32, bf16, f16")
    if b < 1 or v < 1:
        raise ValueError(f"x must be (B, V) with B, V >= 1; got ({b}, {v})")
    nsplit = -(-v // CHUNK)
    route = ONE_PASS if b * nsplit <= resident_blocks else TWO_LAUNCH
    return UnitPlan(route, CHUNK, nsplit, 16 // dtype.itemsize)


@functools.lru_cache(maxsize=None)
def lib():
    so = _build.load("online_softmax")
    so.repro_softmax_stats.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    so.repro_softmax_one_pass.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    so.repro_softmax_normalize.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    so.repro_fused_xent.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    so.repro_unit_blocks_per_sm.argtypes = [ctypes.c_int]
    so.repro_unit_geometry.argtypes = [ctypes.c_void_p]
    so.repro_unit_geometry.restype = None
    for fn in (so.repro_softmax_stats, so.repro_softmax_one_pass,
               so.repro_softmax_normalize, so.repro_fused_xent,
               so.repro_unit_blocks_per_sm):
        fn.restype = ctypes.c_int
    return so


def geometry() -> tuple:
    """(threads, elements per thread, chunk, stated blocks per SM) as the
    built kernels have them; must equal this module's copy."""
    out = (ctypes.c_int * 4)()
    lib().repro_unit_geometry(out)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def device_resident_blocks(index: int, dtype: torch.dtype) -> int:
    """Blocks of the one-pass kernel CUDA device ``index`` holds at once
    for ``dtype``: its occupancy per SM times its SM count, read once."""
    with torch.cuda.device(index):
        per_sm = lib().repro_unit_blocks_per_sm(DTYPES[dtype])
    if per_sm <= 0:
        raise RuntimeError(f"cannot read the one-pass kernel's occupancy "
                           f"on CUDA device {index}: {per_sm}")
    return per_sm * _sm_count(index)


@functools.lru_cache(maxsize=4096)
def _plan(index: int, dtype: torch.dtype, b: int, v: int) -> UnitPlan:
    return unit_plan(dtype, b, v, device_resident_blocks(index, dtype))


def plan_of(x: torch.Tensor) -> UnitPlan:
    """The plan the wrappers launch for CUDA rows ``x``."""
    check_rows(x)
    return _plan(x.get_device(), x.dtype, *x.shape)


# One zeroed ticket buffer per (device, stream): the stats kernel leaves
# it all zeros when it ends, and the launches of one stream run in
# order, so two launches never meet in a ticket.  A graph captured on a
# stream would bake that stream's buffer into replays that may run
# beside later calls on it, so a capture is refused.  The buffers are
# kept for the _MAX_TICKETS streams used last: one that is dropped goes
# back to the caching allocator on the stream that made it, so it is
# not reused before that stream's launches are done with it.
_MAX_TICKETS = 64
_TICKETS: collections.OrderedDict = collections.OrderedDict()


def tickets(index: int, stream: int, b: int) -> int:
    """The address of at least ``b`` zeroed row tickets for launches on
    ``stream`` of CUDA device ``index``; raises inside a CUDA graph
    capture."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("softmax_stats and fused_xent cannot be captured "
                           "in a CUDA graph: their row tickets belong to a "
                           "stream")
    key = (index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < b:          # grows only when B grows
        t = torch.zeros((b,), dtype=torch.int32, device=index)
        _TICKETS[key] = t
        if len(_TICKETS) > _MAX_TICKETS:
            _TICKETS.popitem(last=False)
    _TICKETS.move_to_end(key)
    return t.data_ptr()


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


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stats(x, index, plan, stream):
    """softmax_stats' launch: the scratch (m, l first) and its (m, l)."""
    b, v = x.shape
    buf = torch.empty((2 * b * (plan.nsplit + 1),), dtype=torch.float32,
                      device=x.device)
    raise_on(lib().repro_softmax_stats(
        x.data_ptr(), buf.data_ptr(), tickets(index, stream, b), b, v,
        plan.nsplit, DTYPES[x.dtype], stream), "softmax_stats")
    softmax_stats.launches += 1
    return buf[:b], buf[b:2 * b]


def softmax_stats(x: torch.Tensor):
    """(m (B,) f32, l (B,) f32): the row max and ``sum exp(x - m)``, one
    launch.  x as ``check_rows`` takes it; anything else raises, and so
    does a call inside a CUDA graph capture (see ``tickets``)."""
    check_rows(x)
    index = x.get_device()
    return _stats(x, index, _plan(index, x.dtype, *x.shape),
                  torch._C._cuda_getCurrentRawStream(index))


softmax_stats.launches = 0


def online_softmax(x: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis, (B, V) -> (B, V) f32, on the
    plan's route (one launch, or two).  x as ``check_rows`` takes it;
    anything else raises; the two-launch route, like ``softmax_stats``,
    raises inside a CUDA graph capture."""
    check_rows(x)
    index = x.get_device()
    b, v = x.shape
    plan = _plan(index, x.dtype, b, v)
    stream = torch._C._cuda_getCurrentRawStream(index)
    out = torch.empty((b, v), dtype=torch.float32, device=x.device)
    if plan.route == ONE_PASS:
        buf = torch.empty((2 * b * (plan.nsplit + 1),), dtype=torch.float32,
                          device=x.device)
        raise_on(lib().repro_softmax_one_pass(
            x.data_ptr(), buf.data_ptr(), out.data_ptr(), b, v, plan.nsplit,
            DTYPES[x.dtype], stream), "online_softmax")
    else:
        m, l = _stats(x, index, plan, stream)
        raise_on(lib().repro_softmax_normalize(
            x.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), b, v,
            DTYPES[x.dtype], stream), "online_softmax")
    online_softmax.launches += 1
    online_softmax.launches_by_route[plan.route] += 1
    return out


online_softmax.launches = 0
online_softmax.launches_by_route = dict.fromkeys((ONE_PASS, TWO_LAUNCH), 0)
