"""Dry-run: every (arch x shape x mesh) cell walked one rank at a time on
the ``meta`` device -- whether its plan holds, what a rank holds against
an H100's 80 GB, its FLOPs, bytes and collective bytes, and their
roofline terms.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles the
whole program for 512 host-simulated devices.  The port has nothing to
lower: a cell walks one rank's real step code (``launch.segment_cost``)
on ``meta`` tensors -- shapes and dtypes, no memory -- with its
collectives over ``comm.CountingGroup``s.  ``meta`` is a device of its
own, neither the CPU nor a fallback: the hand kernels take their meta
route (``kernels.meta``), nothing allocates, no card and no process
group is needed, and no ``XLA_FLAGS`` counterpart exists.  Its numbers
are predictions, which ``chip_smoke.py``'s phase 4s holds against the
card's training run (phase 4o).

The rank walked: rank 0 (data index 0, model index 0), unless the model
axis's ranks hold different parameter counts (``sharding.
rank_param_count``), then the model index that holds the most.

Per cell it writes ``<out>/<arch>__<shape>__<mesh>.json`` (resumable:
an existing file is kept unless ``--force``) with the rank's bytes
(``memory``: params, optimizer, gradients, cache, activations and their
total), ``fits_h100_80g``, ``collective_schedule`` (the counting groups'
bytes by kind), ``segments`` and ``totals`` (the reference's keys, plus
``t_bound_s``), ``model_flops`` and ``useful_flops_ratio``.  A cell
that does not run is written as the reference writes it: ``skipped``
with ``shape_applicable``'s reason, or ``error`` with the refusal's own
words (``sharding.plan``'s, e.g. starcoder2-7b's 36 heads at model 16).

Usage (on the CPU-only install too):
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
      --mesh 2x2
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both|DxM]
  python -m repro_torch.launch.roofline           # the table
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Union

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch import hlo_stats, segment_cost
from repro_torch.launch.mesh import mesh_shape
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.parallel import sharding

OPT = AdamWConfig(factored=False)
OUT = "artifacts/dryrun_torch"


def walked_rank(cfg: ModelConfig, kind: str, model: int) -> int:
    """The model index the dry-run walks: 0 where every index of the
    model axis holds the same parameter count, else the first that holds
    the most.  Raises where the plan refuses the split."""
    if model == 1:
        return 0
    counts = [sharding.rank_param_count(cfg, sharding.plan(
        cfg, m, model, whole_vocab=kind == "train")) for m in range(model)]
    return counts.index(max(counts))


def run_cell(arch: str, shape: Union[str, ShapeSpec], mesh: str, *,
             skip_segments: bool = False, head_mode: str = "reduced",
             opt_cfg: AdamWConfig = OPT) -> dict:
    """One cell's record (see the module docstring).  ``shape`` is a
    ``SHAPES`` name or a ``ShapeSpec``; ``mesh`` ``single``, ``multi``
    or ``DxM``; ``head_mode`` the serving head in the total (both are
    costed); ``skip_segments`` walks nothing and records the trees'
    bytes alone.  Raises where the cell's plan refuses it."""
    cfg = get_config(arch)
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    if head_mode not in segment_cost.HEAD_MODES:
        raise ValueError(f"head_mode {head_mode!r}: expected one of "
                         f"{segment_cost.HEAD_MODES}")
    ok, why = shape_applicable(cfg, spec)
    if not ok:
        return {"arch": arch, "shape": spec.name, "mesh": mesh,
                "skipped": why}
    data, model = mesh_shape(mesh)
    rank = walked_rank(cfg, spec.kind, model)
    out = {"arch": arch, "shape": spec.name, "mesh": mesh,
           "kind": spec.kind, "n_chips": data * model, "data": data,
           "model": model, "rank": rank, "head_mode": head_mode}
    t0 = time.time()
    if spec.kind == "train":
        cell = segment_cost.train_cell(cfg, opt_cfg, spec, data, model, rank,
                                       walk=not skip_segments)
    else:
        cell = segment_cost.serve_cell(cfg, spec, data, model, rank,
                                       head_mode=head_mode,
                                       walk=not skip_segments)
    cell["segment_cost_s"] = round(time.time() - t0, 1)
    out.update(cell)
    out["fits_h100_80g"] = cell["memory"]["total"] < hlo_stats.H100_HBM
    if skip_segments:
        return out
    out["collective_schedule"] = cell["totals"]["coll_breakdown"]
    mf = segment_cost.model_flops(cfg, spec)
    flops_global = cell["totals"]["flops_per_dev"] * data * model
    out["model_flops"] = mf
    out["useful_flops_ratio"] = mf / flops_global if flops_global else None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    help="single | multi | both | DxM test mesh")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-segments", action="store_true")
    ap.add_argument("--head-mode", default="reduced",
                    choices=segment_cost.HEAD_MODES)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    for arch, shape in cells:
        for mesh_name in meshes:
            name = f"{arch}__{shape}__{mesh_name}".replace("/", "_")
            path = outdir / f"{name}.json"
            if path.exists() and not args.force:
                print(f"[skip] {name} (exists)")
                continue
            t0 = time.time()
            try:
                res = run_cell(arch, shape, mesh_name,
                               skip_segments=args.skip_segments,
                               head_mode=args.head_mode)
            except Exception as e:  # a refusal is a record too
                res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "error": str(e) or repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
            res["wall_s"] = round(time.time() - t0, 1)
            path.write_text(json.dumps(res, indent=1))
            if "skipped" in res:
                status = "SKIP " + res["skipped"][:40]
            elif "error" in res:
                status = "ERROR " + res["error"][:80]
            else:
                status = (f"ok t={res['wall_s']}s bottleneck="
                          f"{res.get('totals', {}).get('bottleneck')} "
                          f"{res['memory']['total'] / 1e9:.2f} GB a rank")
            print(f"[{arch} x {shape} x {mesh_name}] {status}", flush=True)


if __name__ == "__main__":
    main()
