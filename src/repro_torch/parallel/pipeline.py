"""GPipe-style pipeline parallelism prototype over a ``comm.Group``
(``repro.parallel.pipeline``).

As in the reference, nothing calls it: a (data, model) mesh and remat
bound a training step's memory; it is here, and tested, for a model
whose layers must be cut into stages.

Schedule: the classic GPipe fill-drain of ``n_microbatches`` microbatches
over the group's P ranks, rank ``s`` stage ``s``.  At tick ``t`` stage
``s`` runs microbatch ``t - s`` when ``0 <= t - s < n_microbatches``:
stage 0 reads it from the batch, every other stage receives it from
stage ``s - 1`` (the reference's activation ring, ``ppermute``, as a
send / receive pair), and the last stage keeps its result.  The result
is then broadcast from the last stage (the reference masks and sums).
The bubble fraction is the textbook ``(P - 1) / (M + P - 1)``.

``pipeline_apply(fn_stage, stage_params, x, group, n_microbatches=)``:
``fn_stage(stage_params, x) -> x`` (the same shape), applied P times in
sequence overall; each rank holds only its own stage's params (the
reference's leading stage axis cut over ``pipe``), and ``x``, the whole
batch, on every rank.
"""
from __future__ import annotations

import torch


def pipeline_apply(fn_stage, stage_params, x: torch.Tensor, group, *,
                   n_microbatches: int, kind: str = "pipe") -> torch.Tensor:
    """``fn_{P-1}(... fn_0(x))`` computed pipelined over ``group``; the
    result on every rank.  ``x`` (B, ...) with B a multiple of
    ``n_microbatches``; the activations between stages count under
    ``kind``."""
    n_stages, stage = group.world, group.rank
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"a batch of {B} does not cut into "
                         f"{n_microbatches} microbatches")
    micro = x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])
    out = torch.zeros_like(micro)
    buf = torch.empty_like(micro[0])
    for t in range(n_microbatches + n_stages - 1):
        j = t - stage                   # the microbatch at this stage
        if not 0 <= j < n_microbatches:
            continue
        y = fn_stage(stage_params,
                     micro[j] if stage == 0 else group.recv(buf, stage - 1))
        if stage < n_stages - 1:
            group.send(y, stage + 1, kind)
        else:
            out[j] = y
    group.broadcast(out, n_stages - 1, kind)
    return out.reshape(B, *x.shape[1:])


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
