"""Roofline table from the dry-run's records (``launch.dryrun``).

Counterpart of ``benchmarks/roofline.py``: reads
``artifacts/dryrun_torch/*.json`` and prints one row per (arch, shape,
mesh) -- the three roofline terms of a rank's step (seconds, from the
NVIDIA H100 80GB HBM3 data-sheet peaks in ``launch.hlo_stats``: bounds,
not timings), the bottleneck, the bound, MODEL_FLOPS' share of the
walked FLOPs, the rank's bytes and whether they fit the card's 80 GB.

  python -m repro_torch.launch.roofline [--out DIR] [--mesh single]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import OUT

HEADER = ("| arch | shape | mesh | t_compute (s) | t_memory (s) | "
          "t_collective (s) | bottleneck | t_bound (s) | useful/walked | "
          "GB a rank | fits 80G |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def load(outdir: str = OUT, mesh=None) -> list:
    rows = []
    for p in sorted(Path(outdir).glob("*.json")):
        r = json.loads(p.read_text())
        if mesh and r.get("mesh") != mesh:
            continue
        rows.append(r)
    return rows


def fmt_row(r: dict) -> str:
    head = f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
    if "skipped" in r:
        return (head + " — | — | — | SKIP (" + r["skipped"].split(":")[0]
                + ") | — | — | — | — |")
    if "error" in r:
        return (head + " — | — | — | ERROR (" + r["error"].split(":")[0]
                + ") | — | — | — | — |")
    gb = r["memory"]["total"] / 1e9
    fits = "yes" if r["fits_h100_80g"] else "NO"
    t = r.get("totals")
    if t is None:                      # --skip-segments: bytes alone
        return head + " — |" * 6 + f" {gb:.2f} | {fits} |"
    ratio = r.get("useful_flops_ratio")
    return (head + f" {t['t_compute_s']:.2e} | {t['t_memory_s']:.2e} | "
            f"{t['t_collective_s']:.2e} | {t['bottleneck']} | "
            f"{t['t_bound_s']:.2e} | "
            f"{'—' if ratio is None else f'{ratio:.2f}'} | {gb:.2f} | "
            f"{fits} |")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    print(HEADER)
    for r in load(args.out, args.mesh):
        print(fmt_row(r))


if __name__ == "__main__":
    main()
