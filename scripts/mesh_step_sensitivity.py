"""How far a training step's f32 rounding moves the steps after it.

``chip_smoke.py`` phase 4k holds each mesh run's losses and grad_norms,
step by step, to the 1x1 f32 run's.  A split sums the same terms in
another order, so its gradients differ from the 1x1 run's by rounding
alone; AdamW's first update, ``m / (sqrt(v) + eps)`` with ``m``, ``v``
from one gradient, is about ``lr * sign(g)`` for every element whose
``|g|`` is well above ``eps``, so an element whose gradient sits near
the rounding's size may step the other way.  This script runs phase
4k's 1x1 f32 step of each ``--arch`` (``chip_smoke.mesh_config``: full
width, its MESH_MODELS depth; ``mesh_batches``: B 4 x S 1,024;
``mesh_opt``: MESH_STEPS AdamW steps at lr 1e-3) twice on the same
weights and batches: (a) as it is, and (b) with each step's gradient
taken as two half-batches' gradients summed -- the same function, the
rounding of a 2x1 mesh's data split, in one process.  It prints each
step's loss and grad_norm in both, their relative gaps, and how many of
the first gradient's elements the two runs give opposite signs.

With ``--f64`` it also takes the first step's gradients of the same
weights and batch twice through one function (``lm.hidden``, the head
``h @ W``, ``F.cross_entropy``): in f32 on the card and in f64 on the
host's CPU (every ``.float()`` of an f64 tensor kept in f64; the plain
attention), and prints each leaf's f32 error, ``||g32 - g64|| /
||g64||``, and the error of the gradient at the head's input (``dh``,
through which every other leaf's gradient comes).

    python3 scripts/mesh_step_sensitivity.py \\
        --arch seamless-m4t-large-v2 qwen3-0.6b --f64      # on the card

Writes the numbers to ``chiprun_out/mesh_step_sensitivity.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import optimizer as opt_mod  # noqa: E402
from repro_torch.weights import cast_params, seeded_params  # noqa: E402


@contextlib.contextmanager
def f64_float():
    """Inside: ``.float()`` of an f64 tensor returns it unchanged."""
    to_f32 = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: (
        self if self.dtype == torch.float64 else to_f32(self, *a, **kw))
    try:
        yield
    finally:
        torch.Tensor.float = to_f32


def first_grads(params, cfg, batch, dtype, device):
    """The gradient of every leaf and at the head's input, in ``dtype``
    on ``device``, of the mean cross-entropy of ``h @ W``."""
    c = dataclasses.replace(cfg, dtype="float32" if dtype == torch.float32
                            else "float64", remat="none")
    live = [p.detach().to(device, dtype).requires_grad_(True)
            for p in tree_mod.leaves(params)]
    b = {k: (v.to(device, dtype) if v.is_floating_point() else v.to(device))
         for k, v in batch.items()}
    ctx = f64_float() if dtype == torch.float64 else contextlib.nullcontext()
    with ctx:
        cast = cast_params(tree_mod.unflatten(params, live), c)
        h, _ = lm.hidden(cast, c, b["tokens"],
                         image_embeds=b.get("image_embeds"),
                         src_embeds=b.get("src_embeds"))
        h = h.reshape(-1, h.shape[-1])
        logits = h @ lm.lm_head_weight(cast, c)
        loss = F.cross_entropy(logits, b["labels"].reshape(-1).long())
        grads = torch.autograd.grad(loss, live + [h])
    return [g.double().cpu() for g in grads]


def f64_errors(arch: str, device: str) -> dict:
    """Each leaf's f32 first-step gradient error against f64, and dh's."""
    cfg = cs.mesh_config(arch, "float32")
    params = seeded_params(cfg, cs.MESH_SEED, "cpu")
    batch = cs.mesh_batches(cfg, "cpu")[0]
    g32 = first_grads(params, cfg, batch, torch.float32, device)
    torch.cuda.empty_cache()
    g64 = first_grads(params, cfg, batch, torch.float64, "cpu")
    keys = [tree_mod.key(p) for p, _ in tree_mod.items(params)] + ["dh"]
    errs = {k: ((a - b).norm() / b.norm()).item()
            for k, a, b in zip(keys, g32, g64)}
    return dict(sorted(errs.items(), key=lambda x: -x[1]))


def run(arch: str, device: str, halves: bool) -> dict:
    """MESH_STEPS AdamW steps of ``arch``'s 1x1 f32 run: each step's loss
    and grad_norm, and the first step's gradients (on the host)."""
    cfg = cs.mesh_config(arch, "float32")
    params = seeded_params(cfg, cs.MESH_SEED, device)
    opt = cs.mesh_opt()
    state = {"params": params, "opt": opt_mod.init_state(opt, params)}
    whole = cs.mesh_batches(cfg, device)
    parts = [cs.mesh_batches(cfg, device, 2, d) for d in range(2)]
    out = {"losses": [], "norms": []}
    for s in range(cs.MESH_STEPS):
        if halves:
            # each half's mean loss is half the global mean's share
            got = [steps_mod.rank_grads(state["params"], cfg, p[s])
                   for p in parts]
            loss, grads = (got[0][0] + got[1][0]) / 2, got[0][1]
            for g0, g1 in zip(tree_mod.leaves(grads),
                              tree_mod.leaves(got[1][1])):
                g0.add_(g1).mul_(0.5)
        else:
            loss, grads = steps_mod.rank_grads(state["params"], cfg,
                                               whole[s])
        if s == 0:
            out["first_grads"] = [g.cpu() for g in tree_mod.leaves(grads)]
        m = opt_mod.update(opt, grads, state["opt"], state["params"])
        out["losses"].append(float(loss))
        out["norms"].append(float(m["grad_norm"]))
        del grads
    del state, params
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+",
                    default=["seamless-m4t-large-v2", "qwen3-0.6b"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("mesh_step_sensitivity: CUDA is not available",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        print(cs.card_line(), flush=True)
    res = {}
    for arch in args.arch:
        t0 = time.perf_counter()
        a = run(arch, args.device, False)
        b = run(arch, args.device, True)
        n = sum(g.numel() for g in a["first_grads"])
        flips = sum(int(((ga > 0) != (gb > 0)).logical_and(
            (ga != 0) | (gb != 0)).sum()) for ga, gb in zip(
                a["first_grads"], b["first_grads"]))
        gaps = {k: [abs(x - y) / abs(x) for x, y in zip(a[k], b[k])]
                for k in ("losses", "norms")}
        res[arch] = dict(losses=a["losses"], norms=a["norms"],
                         half_losses=b["losses"], half_norms=b["norms"],
                         loss_gaps=gaps["losses"], norm_gaps=gaps["norms"],
                         sign_flips=flips, elements=n,
                         seconds=time.perf_counter() - t0)
        print(f"{arch}: losses {a['losses']} / two halves {b['losses']} "
              f"(relative gaps {gaps['losses']}); grad_norm {a['norms']} / "
              f"{b['norms']} (relative gaps {gaps['norms']}); the first "
              f"gradient's sign differs in {flips} of {n} elements "
              f"({flips / n:.3g}); {res[arch]['seconds']:.1f} s", flush=True)
        if args.f64:
            t0 = time.perf_counter()
            errs = f64_errors(arch, args.device)
            res[arch]["f32_vs_f64"] = errs
            median = sorted(errs.values())[len(errs) // 2]
            print(f"{arch}: first-step gradients, f32 on {args.device} "
                  f"against f64 on the CPU, ||g32 - g64|| / ||g64||: dh "
                  f"{errs['dh']:.3g}; worst leaves " + ", ".join(
                      f"{k} {v:.3g}" for k, v in list(errs.items())[:6])
                  + f"; median leaf {median:.3g}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "mesh_step_sensitivity.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
