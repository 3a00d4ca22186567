"""Quickstart of the PyTorch/CUDA port: train a tiny LM, then serve it
with the Reduced Softmax unit.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``:
  1. train the reduced qwen3-family config on the synthetic pipeline
     (``repro_torch.launch.train``: the loss through the cross-entropy
     kernel, the attention through the flash kernel on the card);
  2. serve the trained masters greedily through ``LLM`` with the
     paper's comparator head (argmax, no softmax);
  3. check that the tokens equal those of the full-softmax head
     (Theorem 1 on trained weights).

  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
  python examples/quickstart_torch.py          # on the card (default)
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim.optimizer import AdamWConfig  # noqa: E402
from repro_torch.serve.api import LLM  # noqa: E402
from repro_torch.serve.params import SamplingParams  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernel versions)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)

    cfg = smoke_config(get_config("qwen3-0.6b"))
    shape = ShapeSpec("quickstart", seq_len=64, global_batch=8, kind="train")
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.2f}M params on "
          f"{args.device}")
    state, losses = train(
        cfg, shape, AdamWConfig(lr=3e-3, warmup_steps=5,
                                total_steps=args.steps),
        device=args.device, steps=args.steps, log_every=20)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "did not learn"

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).tolist()
    outs = {}
    for mode in ("reduced", "softmax"):
        llm = LLM(state["params"], cfg, n_slots=2, max_len=32, eos_id=-1,
                  head_mode=mode)
        outs[mode] = [o.token_ids for o in llm.generate(
            prompts, SamplingParams(max_new_tokens=8))]
        print(f"{mode:8s} head generation: {outs[mode][0]}")
    assert outs["reduced"] == outs["softmax"], "Theorem 1 violated?!"
    print("reduced == softmax generations (Theorem 1 holds end-to-end)")


if __name__ == "__main__":
    main()
