"""Figs 2 and 3: e^x and s(x) of sorted uniform inputs are monotone --
the order preservation the reduced unit relies on.

Counterpart of ``benchmarks/fig23_monotonicity.py``: the same four
(range, n, tag) cases, each drawn from ``prng.key(1)`` and sorted; s(x)
is ``ops.online_softmax`` (the softmax-unit kernel on the card).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels import ops
from repro_torch.paper import resolve_device

CASES = ((-1, 1, 10, "fig2_main"), (-10, 10, 200, "fig2_inset"),
         (-1, 1, 10, "fig3_main"), (-5, 5, 200, "fig3_inset"))


def run(device="cuda", verbose: bool = True) -> dict:
    """``{tag: monotone}`` for the four cases; raises if one is not."""
    dev = resolve_device(device)
    out = {}
    for lo, hi, n, tag in CASES:
        x = torch.sort(prng.uniform(prng.key(1, device=dev), (n,), lo,
                                    hi)).values
        y = torch.exp(x) if tag.startswith("fig2") \
            else ops.online_softmax(x[None])[0]
        mono = bool(torch.all(torch.diff(y) >= 0))
        out[tag] = mono
        if verbose:
            print(f"{tag}: inputs [{lo},{hi}] n={n} monotone={mono}")
    if not all(out.values()):
        raise AssertionError(f"not monotone: {out}")
    return out


def csv_line(out: dict) -> str:
    return f"fig23,0,monotone_all={all(out.values())}"


def main(device="cuda") -> None:
    print(csv_line(run(device=device)))


if __name__ == "__main__":
    main()
