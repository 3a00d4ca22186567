"""``python -m repro_torch.paper [--device cpu] [--quiet]``: the paper's
three experiments on the port, each ending in its CSV line
(``name,us_per_call,derived``): ``table1`` and ``fig23`` as
``benchmarks/run.py`` prints them, then ``classifier``.  Runs on the card
by default; exits non-zero if a section fails."""
from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch.paper import classifier, fig23, table1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the plain kernel versions)")
    ap.add_argument("--quiet", action="store_true",
                    help="print the CSV lines only")
    args = ap.parse_args(argv)
    verbose = not args.quiet

    def run_classifier():
        res = classifier.run(device=args.device, verbose=verbose)
        if verbose:
            print("\n".join(classifier.op_count_lines()))
        return classifier.csv_line(res)

    sections = [
        ("table1", lambda: table1.csv_line(table1.run(
            device=args.device, verbose=verbose))),
        ("fig23", lambda: fig23.csv_line(fig23.run(
            device=args.device, verbose=verbose))),
        ("classifier", run_classifier),
    ]
    failures = []
    for name, fn in sections:
        if verbose:
            print(f"# --- {name} ---", flush=True)
        try:
            print(fn(), flush=True)
        except Exception as e:
            failures.append(name)
            traceback.print_exc()
            print(f"{name},0,FAILED={e!r}", flush=True)
    if failures:
        print(f"paper sections failed: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
