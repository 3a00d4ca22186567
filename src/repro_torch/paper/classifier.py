"""The paper's own domain: a k-class classifier's output stage.

Counterpart of ``examples/classifier_demo.py``.  A 32 -> 64 -> 10 MLP
is trained 200 steps by SGD at lr 0.1 on softmax cross-entropy (training
needs the real softmax, as the paper notes): the loss is
``ops.softmax_xent``, the cross-entropy kernel on the card, and its
backward the softmax-unit kernel.  The trained model is then deployed
twice, through the full softmax unit (``predict_softmax``: exp, sum,
divide, compare) and through the reduced unit
(``reduced_softmax_predict``: compare only), and the two must agree on
every test input.  Last, the op counts of a 1,000-class output stage.

The JAX script draws its data with ``jax.random.normal`` / ``randint``;
the port's ``prng`` has neither, so ``run`` takes the data and the
initial weights as numpy (a test hands it the JAX script's) or, alone,
draws its own from a seeded ``torch.Generator`` on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import (predict_softmax, reduced_softmax_predict,
                              unit_op_counts)
from repro_torch.kernels import ops
from repro_torch.paper import resolve_device

DIMS = (32, 64, 10)
N_TRAIN, N_TEST = 2000, 500


@dataclasses.dataclass
class Result:
    losses: list               # the training loss before each step
    test_accuracy: float
    agreement: float           # predict_softmax == reduced_softmax_predict
    params: dict               # the trained weights, numpy

    @property
    def loss(self) -> float:
        """The loss of the last step, as the JAX script prints it."""
        return self.losses[-1]


def make_data(seed: int = 0) -> dict:
    """Synthetic 10-class data as the JAX script builds it -- class
    centres N(0, 4) in 32 dimensions, points N(centre, 1) -- from a host
    ``torch.Generator``: numpy ``xtr`` (2000, 32), ``ytr``, ``xte`` (500,
    32), ``yte``."""
    g = torch.Generator().manual_seed(seed)
    d_in, _, k = DIMS
    centers = torch.randn((k, d_in), generator=g) * 2.0

    def draw(n):
        y = torch.randint(0, k, (n,), generator=g)
        return (centers[y] + torch.randn((n, d_in), generator=g)).numpy(), \
            y.numpy()

    xtr, ytr = draw(N_TRAIN)
    xte, yte = draw(N_TEST)
    return dict(xtr=xtr, ytr=ytr, xte=xte, yte=yte)


def init_weights(seed: int = 0) -> dict:
    """The JAX script's initial weights' shapes and scales, numpy."""
    g = torch.Generator().manual_seed(seed + 1)
    d_in, d_h, k = DIMS
    return dict(w1=(torch.randn((d_in, d_h), generator=g) * 0.18).numpy(),
                b1=np.zeros(d_h, np.float32),
                w2=(torch.randn((d_h, k), generator=g) * 0.125).numpy(),
                b2=np.zeros(k, np.float32))


def logits_fn(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def run(data: Optional[dict] = None, params: Optional[dict] = None, *,
        seed: int = 0, steps: int = 200, lr: float = 0.1, device="cuda",
        verbose: bool = True) -> Result:
    """Train, deploy both units, compare; raises unless they agree on
    every test input.  ``data`` and ``params`` are numpy dicts
    (``make_data`` / ``init_weights`` keys); None draws them from
    ``seed``."""
    dev = resolve_device(device)
    data = make_data(seed) if data is None else data
    params = init_weights(seed) if params is None else params
    t = {k: torch.tensor(np.asarray(v), device=dev) for k, v in
         data.items()}
    xtr, xte = t["xtr"].float(), t["xte"].float()
    ytr, yte = t["ytr"].long(), t["yte"].long()
    p = {k: torch.tensor(np.asarray(v, np.float32), device=dev,
                         requires_grad=True) for k, v in params.items()}
    losses = []
    for _ in range(steps):
        # training NEEDS the softmax: eq (4) of the paper, through the
        # cross-entropy kernel and, backward, the softmax-unit kernel
        loss = ops.softmax_xent(logits_fn(p, xtr), ytr).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for w, gw in zip(p.values(), grads):
                w.sub_(lr * gw)
        losses.append(float(loss.detach()))
    with torch.no_grad():
        logits = logits_fn(p, xte)
        pred_soft = predict_softmax(logits)            # baseline unit
        pred_reduced = reduced_softmax_predict(logits)  # the paper's unit
        agree = float((pred_soft == pred_reduced).float().mean())
        acc = float((pred_reduced == yte).float().mean())
    if verbose:
        print(f"train loss after {steps} steps: {losses[-1]:.4f}")
        print(f"test accuracy: {acc:.3f}")
        print(f"softmax-unit vs reduced-unit agreement: {agree:.3f}")
    if agree != 1.0:
        raise AssertionError(f"the reduced unit disagrees with the softmax "
                             f"unit on {1 - agree:.3%} of the test set")
    return Result(losses, acc, agree,
                  {k: v.detach().cpu().numpy() for k, v in p.items()})


def op_count_lines(k: int = 1000) -> list:
    """The JAX script's closing lines: each unit's ops for one k-class
    decision (the paper's 1000-class object detector)."""
    ops_ = unit_op_counts(k)
    s, r = ops_["softmax"], ops_["reduced (ours)"]
    return [f"{k}-class output stage, per classification:",
            f"  softmax unit: {s['exp']} exp, {s['add']} add, {s['div']} "
            f"div, {s['cmp']} cmp",
            f"  reduced unit: {r['exp']} exp, {r['add']} add, {r['div']} "
            f"div, {r['cmp']} cmp   <- comparator only"]


def csv_line(res: Result) -> str:
    return (f"classifier,0,agreement={res.agreement:.3f}"
            f"_test_accuracy={res.test_accuracy:.3f}")


def main(device="cuda") -> None:
    res = run(device=device)
    print()
    print("\n".join(op_count_lines()))
    print(csv_line(res))


if __name__ == "__main__":
    main()
