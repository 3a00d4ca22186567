#!/usr/bin/env python3
"""Time one checkout's softmax-unit wrappers on one NVIDIA GPU, and the
memory of the cross-entropy's backward.

    python3 scripts/unit_xent_bench.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default; another commit's unpacked ``src`` to compare two
versions in one run: parent, change, change, parent).  The timer is
``chip_smoke.Timer`` of this checkout, so both versions are read on one
ruler.  Cases, with seeded inputs that are the same in every run on one
card:

- ``fused_xent``, ``softmax_stats`` and ``online_softmax`` at (12,
  151936) f32 (the unit path), (512, 151936) bf16 and (4096, 151936)
  bf16 (one 4k-token training sequence of qwen3-0.6b), each read as
  call, device and host ms, with ``fused_xent``'s device kernels per
  call from a profiler trace;
- ``ops.softmax_xent`` forward then backward at (12, 151936) f32 and
  (4096, 151936) bf16: the bytes the backward allocates beyond what is
  live before it (``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats``) and a SHA-256 of the gradient's bytes, so
  two versions' gradients can be compared bit for bit.

Prints one JSON object per case and writes them all to
``build/unit_xent_bench_<label>.json`` (gitignored).  Exits non-zero
without CUDA.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 151936
SHAPES = ((12, "float32"), (512, "bfloat16"), (4096, "bfloat16"))


def kernel_names(torch, fn) -> list:
    """Device kernels one call of ``fn`` launched (``chip_smoke``'s
    ``device_kernels``), filtered to the softmax unit's: those of this
    checkout and, for an older checkout, its two cross-entropy kernels
    (``stats_partial_kernel``, ``xent_merge_kernel``)."""
    import chip_smoke

    return [n for n in chip_smoke.device_kernels(torch, fn, "_kernel")
            if "unit_" in n or "xent" in n or "stats_partial" in n
            or "normalize_kernel" in n]


def backward_case(torch, ops, b, dtype, gen) -> dict:
    x = (torch.randn((b, V), generator=gen, device="cuda") * 4).to(dtype)
    lab = torch.randint(0, V, (b,), generator=gen, device="cuda")
    xg = x.clone().requires_grad_(True)
    loss = ops.softmax_xent(xg, lab).mean()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    loss.backward()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    grad = xg.grad.contiguous().view(torch.uint8).cpu().numpy()
    return {"case": f"softmax_xent backward B={b} {str(dtype)[6:]}",
            "extra_bytes": extra, "extra_gb": extra / 1e9,
            "grad_dtype": str(xg.grad.dtype)[6:],
            "grad_sha256": hashlib.sha256(grad.tobytes()).hexdigest()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("unit_xent_bench: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.kernels import online_softmax as osm
    from repro_torch.kernels import ops

    _build.build_all(("online_softmax",))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{args.label}: {card}; repro_torch from {fx.__file__}",
          flush=True)
    timer = chip_smoke.Timer(torch)
    out = []
    floor = timer.readings(lambda: torch.cuda._sleep(1))
    out.append({"case": "empty launch", **floor})
    print(json.dumps(out[-1]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(20)
    for b, dt in SHAPES:
        dtype = getattr(torch, dt)
        x = (torch.randn((b, V), generator=gen, device="cuda") * 4).to(dtype)
        lab = torch.randint(0, V, (b,), generator=gen, device="cuda")
        for name, fn in (("fused_xent", lambda: fx.fused_xent(x, lab)),
                         ("softmax_stats", lambda: osm.softmax_stats(x)),
                         ("online_softmax", lambda: osm.online_softmax(x))):
            row = {"case": f"{name} B={b} {dt}", **timer.readings(fn)}
            if name == "fused_xent":
                row["device_kernels"] = kernel_names(torch, fn)
            out.append(row)
            print(json.dumps(out[-1]), flush=True)
        del x, lab
        torch.cuda.empty_cache()
    del timer
    torch.cuda.empty_cache()
    for b, dt in ((12, "float32"), (4096, "bfloat16")):
        out.append(backward_case(torch, ops, b, getattr(torch, dt), gen))
        print(json.dumps(out[-1]), flush=True)
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build",
                           f"unit_xent_bench_{args.label}.json"), "w") as f:
        json.dump({"label": args.label, "card": card, "cases": out}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
