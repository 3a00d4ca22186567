"""The hand kernels' ``meta`` route: shapes and dtypes, no memory, no card.

``ops`` sends tensors on the ``meta`` device here (the dry-run walks a
rank's step so, ``launch.dryrun``).  Each kernel is one operator of the
``repro_torch_meta`` library whose Meta implementation returns outputs
of the CUDA wrapper's shapes and dtypes and runs nothing else: in
particular not the plain version, whose (B, H, T, S) scores the card
never holds.  Around the operator the entry allocates, on ``meta``, the
scratch the CUDA wrapper allocates (paged attention's split partials,
the heads' pass-1 partials, the softmax unit's buffer), at the plans the
wrappers take on an H100 (``fused_argmax_head.H100_SMS`` /
``H100_SMEM_OPTIN``), and frees it after the call, as the wrapper does
(the softmax unit's outputs are views of its buffer on the card; here
they are tensors of their own and the buffer, 2 B (nsplit + 1) f32, is
freed after the call).

Counting, for ``torch.utils.flop_counter.FlopCounterMode`` and the
dry-run's counter (``launch.hlo_stats``): each operator is one op whose
FLOPs are registered (``register_flop_formula``) as what
``FlopCounterMode`` counts for its plain version (``ref``) at the same
shapes -- that version run on ``meta`` under a counter of its own -- and
whose bytes, as the counter reads any op, are its inputs read once and
its outputs written once: the kernels' bound rule.

The flash backward has no kernel: ``ops.flash_attention_backward`` runs
its plain recompute on ``meta`` as it does on the card, and is counted
op by op.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from repro_torch.kernels import fused_argmax_head as _fah
from repro_torch.kernels import fused_topk_head as _ftk
from repro_torch.kernels import online_softmax as _os
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

NAMESPACE = "repro_torch_meta"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def _def(schema: str, impl, plain):
    """Define the operator ``schema``, its Meta implementation ``impl``
    and its FLOP formula: ``plain``'s ops counted at the call's shapes."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "Meta")
    op = getattr(getattr(torch.ops, NAMESPACE), name)

    @register_flop_formula(op, get_raw=True)
    def _flops(*args, out_val=None, **kwargs):
        with FlopCounterMode(display=False) as fc:
            plain(*args, **kwargs)
        return fc.get_total_flops()

    return op


def _flash_impl(q, k, v, causal, window):
    return torch.empty_like(q)


def _paged_impl(q, k_pool, v_pool, block_tables, positions, attn_approx,
                window):
    return torch.empty_like(q)


def _argmax_impl(h, w):
    b = h.shape[0]
    return (_empty((b,), torch.int32, h), _empty((b,), torch.float32, h))


def _verify_impl(h, w, cand, with_value):
    b, t = h.shape[:2]
    out = [_empty((b, t), torch.int32, h), _empty((b,), torch.int32, h)]
    if with_value:
        out.append(_empty((b, t), torch.float32, h))
    return out


def _topk_impl(h, w, k):
    b = h.shape[0]
    return (_empty((b, k), torch.float32, h), _empty((b, k), torch.int32, h))


def _stats_impl(x):
    b = x.shape[0]
    return (_empty((b,), torch.float32, x), _empty((b,), torch.float32, x))


def _softmax_impl(x):
    return _empty(tuple(x.shape), torch.float32, x)


def _xent_impl(logits, labels):
    return _empty((logits.shape[0],), torch.float32, logits)


def _verify_plain(h, w, cand, with_value):
    return ref.verify_draft_with_value(h, w, cand)


def _paged_plain(q, k_pool, v_pool, block_tables, positions, attn_approx,
                 window):
    return ref.paged_attention(q, k_pool, v_pool, block_tables, positions,
                               attn_approx=attn_approx, window=window)


_FLASH = _def("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
              "int? window) -> Tensor", _flash_impl,
              lambda q, k, v, causal, window: ref.flash_attention(
                  q, k, v, causal=causal, window=window))
_PAGED = _def("paged_attention(Tensor q, Tensor k_pool, Tensor v_pool, "
              "Tensor block_tables, Tensor positions, str attn_approx, "
              "int? window) -> Tensor", _paged_impl, _paged_plain)
_ARGMAX = _def("fused_argmax_head(Tensor h, Tensor w) -> (Tensor, Tensor)",
               _argmax_impl, ref.fused_argmax_head_with_value)
_VERIFY = _def("fused_verify_head(Tensor h, Tensor w, Tensor cand, "
               "bool with_value) -> Tensor[]", _verify_impl, _verify_plain)
_TOPK = _def("fused_topk_head(Tensor h, Tensor w, int k) -> (Tensor, "
             "Tensor)", _topk_impl, ref.fused_topk_head)
_STATS = _def("softmax_stats(Tensor x) -> (Tensor, Tensor)", _stats_impl,
              ref.softmax_stats)
_SOFTMAX = _def("online_softmax(Tensor x) -> Tensor", _softmax_impl,
                ref.online_softmax)
_XENT = _def("fused_xent(Tensor logits, Tensor labels) -> Tensor",
             _xent_impl, ref.fused_xent)

# every operator of the route, by the name of its ``ops`` entry's kernel
OPERATORS = {"flash_attention": _FLASH, "paged_attention": _PAGED,
             "fused_argmax_head": _ARGMAX, "fused_verify_head": _VERIFY,
             "fused_topk_head": _TOPK, "softmax_stats": _STATS,
             "online_softmax": _SOFTMAX, "fused_xent": _XENT}


def _unit_scratch(x: torch.Tensor) -> list:
    """The softmax unit's buffer (``online_softmax._stats``, the one-pass
    route and ``fused_xent`` allocate the same): 2 B (nsplit + 1) f32."""
    b, v = x.shape
    return [_empty((2 * b * (-(-v // _os.CHUNK) + 1),), torch.float32, x)]


def flash_attention(q, k, v, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    return _FLASH(q, k, v, causal, window)


def paged_attention(q, k_pool, v_pool, block_tables, positions,
                    attn_approx: str, window: Optional[int]) -> torch.Tensor:
    """The wrapper's split partials (``rows * (hd + 2)`` f32 when the
    table spans more than one chunk) and the pre-pass's chunk maxima
    (``rows`` f32 in the base2 / pwl modes) live across the call."""
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    t = q.shape[1] if q.dim() == 4 else 1
    n_chunks, _ = _pa.split_for(q, k_pool, block_tables)
    rows = b * t * hq * n_chunks
    scratch = []
    if n_chunks > 1:
        scratch.append(_empty((rows * (hd + 2),), torch.float32, q))
    if attn_approx in _pa.PREMAX_MODES:
        scratch.append(_empty((rows,), torch.float32, q))
    out = _PAGED(q, k_pool, v_pool, block_tables, positions, attn_approx,
                 window)
    del scratch
    return out


def _head_partials(rows: int, nsplit: int, like, k: int = 1) -> list:
    shape = (rows, nsplit) if k == 1 else (rows, nsplit, k)
    return [_empty(shape, torch.float32, like),
            _empty(shape, torch.int32, like)]


def fused_argmax_head_with_value(h, w):
    plan = _fah.head_plan(tuple(h.shape), w.shape[1], h.dtype)
    scratch = _head_partials(h.shape[0], plan.nsplit, h)
    out = _ARGMAX(h, w)
    del scratch
    return out


def fused_verify_head(h, w, cand, with_value: bool):
    b, t = h.shape[:2]
    plan = _fah.head_plan(tuple(h.shape), w.shape[1], h.dtype)
    scratch = _head_partials(b * t, plan.nsplit, h)
    out = tuple(_VERIFY(h, w, cand, with_value))
    del scratch
    return out


def fused_topk_head(h, w, k: int):
    b, d = h.shape
    plan = _ftk.topk_plan(b, d, w.shape[1], h.dtype)
    n1 = -(-plan.nsplit // _ftk._LISTS_PER_BLOCK)
    scratch = (_head_partials(b, plan.nsplit, h, k)
               + _head_partials(b, n1, h, k))
    out = _TOPK(h, w, k)
    del scratch
    return out


def softmax_stats(x):
    scratch = _unit_scratch(x)
    out = _STATS(x)
    del scratch
    return out


def online_softmax(x):
    scratch = _unit_scratch(x)
    out = _SOFTMAX(x)
    del scratch
    return out


def fused_xent(logits, labels):
    scratch = _unit_scratch(logits)
    out = _XENT(logits, labels)
    del scratch
    return out
