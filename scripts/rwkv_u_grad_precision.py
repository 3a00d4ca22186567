"""Where rwkv6's f32 gradient of the bonus ``u`` loses its precision.

``chip_smoke.py`` phase 4k holds each mesh run's first-step gradients to
the 1x1 f32 run's.  For rwkv6-7b the 1x1 run's own ``u`` gradient is far
from exact; this script takes the first step's gradients twice on the
same weights and batch -- in f32, and in f64 through the same functions
(every ``.float()`` of an f64 tensor kept in f64, the loss the mean
cross-entropy of the f64 logits) -- and splits the ``u`` gradient's error
by its factors.  In layer 0, u's gradient is the sum over the tokens of
``r_i k_i (dout . v)``, ``dout`` the gradient reaching the wkv scan's
output; it is recomputed in f64 from the f64 run's r, k, v and dout with
each factor in turn swapped for the f32 run's.  It also reads the
gradient at the ``ln_x`` group norm's output, the step before ``dout``,
and splits both by position, each row's first token against the rest
(``by_position``).

    python3 scripts/rwkv_u_grad_precision.py              # CPU, d 1,024
    python3 scripts/rwkv_u_grad_precision.py --full --device cuda

``--full``: rwkv6-7b at full width (d 4,096, 64 heads of 64, d_ff 14,336,
V 65,536), 2 of 32 layers, B 2 x S 1,024 (half phase 4k's batch, so the
f64 run's saved scan states fit one card); else d 1,024, 16 heads, d_ff
3,584, V 8,192, B 2 x S 1,024, 2 layers.  No remat.  Prints each
number and writes them to ``chiprun_out/rwkv_u_grad_precision.json``.
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

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import lm, rwkv6  # noqa: E402
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


@contextlib.contextmanager
def layer0_capture(box: dict):
    """Inside: layer 0's scan inputs r, k, v and the gradients at its
    output (``dout``) and at its ``ln_x`` group norm's output go to
    ``box``."""
    scan, norm = rwkv6.wkv_scan, rwkv6.group_norm_heads

    def scan0(S, r, k, v, w, u):
        out, S = scan(S, r, k, v, w, u)
        if "r" not in box:
            box.update(r=r.detach(), k=k.detach(), v=v.detach())
            out.register_hook(lambda g: box.__setitem__("dout", g.detach()))
        return out, S

    def norm0(x, scale, n_heads):
        y = norm(x, scale, n_heads)
        if "norm" not in box:
            box["norm"] = (x.detach(), scale.detach(), n_heads)
            y.register_hook(lambda g: box.__setitem__("dnorm", g.detach()))
        return y

    rwkv6.wkv_scan, rwkv6.group_norm_heads = scan0, norm0
    try:
        yield
    finally:
        rwkv6.wkv_scan, rwkv6.group_norm_heads = scan, norm


def first_grads(params, cfg, batch, dtype):
    """(loss, the gradient of every leaf, layer 0's captures) in ``dtype``
    (f32 or f64)."""
    box = {}
    c = dataclasses.replace(cfg, dtype="float32" if dtype == torch.float32
                            else "float64")
    live = [p.detach().to(dtype).requires_grad_(True)
            for p in tree_mod.leaves(params)]
    ctx = f64_float() if dtype == torch.float64 else contextlib.nullcontext()
    with ctx, layer0_capture(box):
        cast = cast_params(tree_mod.unflatten(params, live), c)
        h, _ = lm.hidden(cast, c, batch["tokens"])
        logits = h.reshape(-1, h.shape[-1]) @ lm.lm_head_weight(cast, c)
        loss = F.cross_entropy(logits, batch["labels"].reshape(-1).long())
        grads = torch.autograd.grad(loss, live)
    return loss.item(), grads, box


def rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def u_grad(f):
    """Layer 0's u gradient from its factors, in f64: the sum over the
    tokens of ``r_i k_i (dout . v)``, (H, hd)."""
    r, k, v, d = (f[n].double() for n in ("r", "k", "v", "dout"))
    return (r * k * (d * v).sum(-1, keepdim=True)).sum((0, 1))


def by_position(f32, f64) -> dict:
    """Layer 0 split by position, the first token of each row against the
    rest: the ``ln_x`` norm's per-head spread sqrt(var + eps) (median),
    each part's share of |dout|^2, and the f32 error of dout and of the
    gradient at the norm's output (``dnorm``) in each part.  The norm's
    backward divides by that spread, so where it is small (the first
    token, whose wkv state is still zero) dout is large."""
    x, _, h = f64["norm"]
    x = x.double().reshape(*x.shape[:-1], h, -1)
    sig = ((x - x.mean(-1, keepdim=True)).pow(2).mean(-1) + 64e-5).sqrt()
    out = {}
    for name in ("dout", "dnorm"):
        want = f64[name].double().reshape(x.shape)
        err = (f32[name].double().reshape(x.shape) - want).pow(2).sum(-1)
        size = want.pow(2).sum(-1)                       # (B, T, H)
        for part, sl in (("first", slice(0, 1)), ("rest", slice(1, None))):
            out[f"{name}_{part}_err"] = (err[:, sl].sum()
                                         / size[:, sl].sum()).sqrt().item()
            out[f"{name}_{part}_share"] = (size[:, sl].sum()
                                           / size.sum()).item()
    out["sigma_first_median"] = sig[:, 0].median().item()
    out["sigma_rest_median"] = sig[:, 1:].median().item()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    full = get_config("rwkv6-7b")
    if args.full:
        cfg = dataclasses.replace(full, n_layers=2, remat="none")
    else:
        cfg = dataclasses.replace(full, n_layers=2, d_model=1024, n_heads=16,
                                  n_kv_heads=16, d_ff=3584, vocab_size=8192,
                                  remat="none")
    batch = TokenPipeline(DataConfig(seed=0, vocab_size=cfg.vocab_size), cfg,
                          ShapeSpec("probe", 1024, 2, "train"),
                          args.device).batch(0)
    params = seeded_params(dataclasses.replace(cfg, dtype="float32"), 0,
                           args.device)
    t0 = time.perf_counter()
    l32, g32, f32 = first_grads(params, cfg, batch, torch.float32)
    l64, g64, f64 = first_grads(params, cfg, batch, torch.float64)
    out = {"config": f"{cfg.name} d {cfg.d_model} V {cfg.vocab_size} "
           f"{cfg.n_layers} layers B 2 x S 1024", "device": args.device,
           "loss_f32": l32, "loss_f64": l64,
           "seconds": time.perf_counter() - t0}
    if args.device.startswith("cuda"):
        out["card"] = torch.cuda.get_device_name(0)
    errs = {tree_mod.key(p): rel(a, b) for (p, _), a, b in
            zip(tree_mod.items(params), g32, g64)}
    out["leaf_f32_vs_f64"] = dict(sorted(errs.items(), key=lambda x: -x[1]))
    paths = [p for p, _ in tree_mod.items(params)]
    iu = next(i for i, p in enumerate(paths) if tree_mod.key(p).endswith(
        "/u"))
    want = g64[iu][0].reshape(u_grad(f64).shape)
    out["u0_f32_vs_f64"] = rel(g32[iu][0].reshape(want.shape), want)
    out["u0_formula_f64_vs_autograd"] = rel(u_grad(f64), want)
    out["u0_with_one_f32_factor"] = {
        n: rel(u_grad(dict(f64, **{n: f32[n]})), want)
        for n in ("r", "k", "v", "dout")}
    out["factor_f32_vs_f64"] = {n: rel(f32[n], f64[n])
                                for n in ("r", "k", "v", "dout", "dnorm")}
    out["layer0_by_position"] = by_position(f32, f64)
    for k, v in out.items():
        if k != "leaf_f32_vs_f64":
            print(f"{k}: {v}")
    print("leaf_f32_vs_f64 (worst 6): " + ", ".join(
        f"{k} {v:.3g}" for k, v in list(out["leaf_f32_vs_f64"].items())[:6]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "rwkv_u_grad_precision.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
