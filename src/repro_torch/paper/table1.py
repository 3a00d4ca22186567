"""Table I: softmax outputs over three input regimes.

Counterpart of ``benchmarks/table1.py``: 10 uniform samples each from
[-100, 0], [0, 100] and [-1, 1] (``prng.uniform``, bit for bit
``jax.random.uniform`` under the same key); for each, the input, e^x and
s(x), and whether the largest input has the largest probability (Theorem
1).  s(x) is the full softmax unit, ``ops.online_softmax`` -- the
softmax-unit kernel on the card.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels import ops
from repro_torch.paper import resolve_device

REGIMES = ((-100, 0, "all-negative"), (0, 100, "all-positive"),
           (-1, 1, "random"))


def run(seed: int = 0, device="cuda", verbose: bool = True) -> list:
    """Rows ``(name, x, e^x, s(x), agree)`` (numpy f32 arrays of 10) for
    the three regimes; raises if any regime's argmax moves."""
    dev = resolve_device(device)
    rows = []
    for lo, hi, name in REGIMES:
        x = prng.uniform(prng.key(seed, device=dev), (10,), lo, hi)
        e = torch.exp(x)
        s = ops.online_softmax(x[None])[0]
        agree = int(torch.argmax(x)) == int(torch.argmax(s))
        rows.append((name, x.cpu().numpy(), e.cpu().numpy(),
                     s.cpu().numpy(), agree))
        if verbose:
            print(f"-- {name} [{lo},{hi}]  argmax(x)==argmax(s): {agree}")
            for xi, ei, si in zip(*rows[-1][1:4]):
                print(f"   {xi:10.2f}  {ei:12.3e}  {si:12.3e}")
    if not all(r[-1] for r in rows):
        raise AssertionError("Theorem 1 failed: an argmax moved under s(x)")
    return rows


def csv_line(rows) -> str:
    return ("table1,0,all_regimes_argmax_preserved="
            f"{all(r[-1] for r in rows)}")


def main(device="cuda") -> None:
    print(csv_line(run(device=device, verbose=True)))


if __name__ == "__main__":
    main()
