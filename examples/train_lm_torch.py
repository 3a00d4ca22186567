"""Train the ~100M-param LM of ``examples/train_lm.py`` on the PyTorch/CUDA
port: 10 layers, d_model 640, GQA 10/2 heads of 64, 32k vocab
(~106M params), f32, no remat -- the synthetic pipeline, the train step,
checkpointing, the straggler monitor and the preemption guard of
``repro_torch.launch.train``.

  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
  python examples/train_lm_torch.py --steps 300      # on the card
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim.optimizer import AdamWConfig  # noqa: E402

CONFIG_100M = ModelConfig(
    name="repro-100m", family="dense",
    n_layers=10, d_model=640, n_heads=10, n_kv_heads=2, head_dim=64,
    d_ff=2560, vocab_size=32064,
    activation="silu_glu", qk_norm=True, rope_theta=10_000.0,
    dtype="float32", remat="none",
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint every 100 steps here (and resume)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernel versions)")
    args = ap.parse_args(argv)

    cfg = CONFIG_100M
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params on "
          f"{args.device}")
    shape = ShapeSpec("train_lm", args.seq, args.batch, "train")
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                      weight_decay=0.01)
    state, losses = train(
        cfg, shape, opt, device=args.device, steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=100,
        data_cfg=DataConfig(seed=0, vocab_size=512))
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"min {min(losses):.4f}")
    assert losses[-1] < losses[0], "did not learn"


if __name__ == "__main__":
    main()
