"""End-to-end training loop (``repro.launch.train``): config -> seeded
f32 masters on the device -> data pipeline -> train step -> checkpoint
manager, with the preemption guard and the straggler monitor.

Usage (CPU, smoke config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --steps 20
On the card (``--device cuda``, the default) the step's attention is
the flash-attention kernel and its loss the cross-entropy kernel.
Training runs on one device: ``--mesh`` other than ``1x1`` raises.
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch import weights
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.optim import optimizer as opt_mod
from repro_torch.runtime.fault_tolerance import (PreemptionGuard, StepTimer,
                                                 StragglerMonitor)


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the card "
            "(pass --device cpu to run the plain kernel versions)")
    return device


def check_mesh(mesh: Optional[str]) -> None:
    if mesh is not None and tuple(int(x) for x in mesh.split("x")) != (1, 1):
        raise ValueError(
            f"--mesh {mesh}: the port trains on one device; training under "
            "tensor and data parallelism is ROADMAP.md's training-under-tp "
            "entry (section 1, item 4)")


def train(cfg: ModelConfig, shape: ShapeSpec, opt_cfg, *, device="cuda",
          steps: int = 20, ckpt_dir=None, ckpt_every: int = 50,
          data_cfg: Optional[DataConfig] = None, log_every: int = 10,
          log=print):
    """Train ``steps`` steps (from the latest checkpoint under
    ``ckpt_dir`` when there is one); returns (state, the losses of the
    steps run).  The masters are ``weights.seeded_params(cfg,
    data_cfg.seed)``, f32, on ``device``; a checkpoint is written every
    ``ckpt_every`` steps and on SIGTERM / SIGINT, asynchronously, and
    waited for at the end."""
    device = resolve_device(device)
    data_cfg = data_cfg or DataConfig(vocab_size=cfg.vocab_size)
    params = weights.seeded_params(cfg, data_cfg.seed, device)
    state = {"params": params, "opt": opt_mod.init_state(opt_cfg, params)}
    step_fn = steps_mod.make_train_step(cfg, opt_cfg)
    pipe = TokenPipeline(data_cfg, cfg, shape, device)

    mgr = CheckpointManager(ckpt_dir, keep_last_k=2,
                            async_save=True) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        del state
        state = mgr.restore(start, steps_mod.train_state_struct(
            cfg, opt_cfg), device=device)
        log(f"[restore] resumed from step {start}")

    monitor = StragglerMonitor(log_fn=log)
    losses = []
    with PreemptionGuard() as guard:
        for step in range(start, steps):
            batch = pipe.batch(step)
            with StepTimer() as t:
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
            monitor.record(step, t.dt)
            losses.append(loss)
            if step % log_every == 0 or step == steps - 1:
                log(f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} {t.dt*1e3:.0f}ms")
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, state)
            if guard.requested:
                log(f"[preempt] signal at step {step}; checkpointing")
                if mgr:
                    mgr.save(step + 1, state)
                break
    if mgr:
        mgr.wait()
    return state, losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="a named shape (train_4k); default --seq x --batch")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default=None,
                    help="only 1x1: the port trains on one device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernel versions)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    check_mesh(args.mesh)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.shape:
        shape = SHAPES[args.shape]
    else:
        shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                  total_steps=max(args.steps, 10))
    return train(cfg, shape, opt_cfg, device=args.device, steps=args.steps,
                 ckpt_dir=args.ckpt_dir)


if __name__ == "__main__":
    main()
