"""Where a speculative step's bf16 bits part from a plain step's, at
starcoder2-7b's widths, on one NVIDIA GPU.

A draft window of T queries runs the trunk's matrix products over B x T
rows where a plain decode step runs them over B.  This probe checks,
on random bf16 operands:

  - each of starcoder2-7b's trunk products (d 4,608 -> q / kv / d_ff
    18,432 and back): a row's result inside an M 64 product against the
    same row in an M 8 product and alone (M 1);
  - paged attention at g 9 (36 query heads over 4 KV heads): each row at
    T 1 against every column of a T 8 window that repeats its position.

    PYTHONPATH=src python scripts/batch_bits_probe.py

Prints one line per check and a JSON summary; exits non-zero without a
card.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

# starcoder2-7b's trunk products as (K, N): wq, wk / wv, wo, w_in, w_out
PRODUCTS = ((4608, 4608), (4608, 512), (4608, 4608), (4608, 18432),
            (18432, 4608))


def gemm_rows(gen, k, n) -> dict:
    x = torch.randn((64, k), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=gen, device="cuda")
         / k ** 0.5).bfloat16()
    y64, y8, y1 = x @ w, x[:8] @ w, x[:1] @ w
    return {"m8_in_m64_equal": torch.equal(y64[:8], y8),
            "max_diff": (y64[:8].float() - y8.float()).abs().max().item(),
            "m1_in_m8_equal": torch.equal(y8[:1], y1)}


def paged_rows(seed=3) -> bool:
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(seed)
    b, hq, hkv, hd, bs = 8, 36, 4, 128, 16
    last = rng.integers(0, 1000, size=b)
    nbs = last // bs + 1
    nb = 1 << int(nbs.max() - 1).bit_length()
    perm = rng.permutation(int(nbs.sum()))
    table, k0 = np.empty((b, nb), np.int32), 0
    for r, n in enumerate(nbs):
        table[r, :n] = perm[k0:k0 + n]
        table[r, n:] = perm[k0]
        k0 += n

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            "cuda", torch.bfloat16)

    q, kp, vp = rand(b, hq, hd), rand(len(perm), bs, hkv, hd), rand(
        len(perm), bs, hkv, hd)
    bt = torch.from_numpy(table).cuda()
    pos = torch.from_numpy(last.astype(np.int32)).cuda()
    o1 = pa.paged_attention(q, kp, vp, bt, pos)
    q8 = q[:, None].expand(b, 8, hq, hd).contiguous()
    o8 = pa.paged_attention(q8, kp, vp, bt,
                            pos[:, None].expand(b, 8).contiguous())
    torch.cuda.synchronize()
    return all(torch.equal(o8[:, j], o1) for j in range(8))


def main() -> int:
    if not torch.cuda.is_available():
        print("batch_bits_probe: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "gemm": {}}
    for k, n in PRODUCTS:
        r = gemm_rows(gen, k, n)
        out["gemm"][f"K{k}_N{n}"] = r
        print(f"bf16 GEMM K={k} N={n}: a row inside M 64 == the same row "
              f"at M 8: {r['m8_in_m64_equal']} (max diff "
              f"{r['max_diff']:.4g}); M 1 == M 8: {r['m1_in_m8_equal']}",
              flush=True)
    out["paged_g9_t1_equals_t8"] = paged_rows()
    print("paged attention g 9: each row at T 1 == every column of T 8: "
          f"{out['paged_g9_t1_equals_t8']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
