"""End-to-end training loop (``repro.launch.train``): config -> seeded
f32 masters on the device -> data pipeline -> train step -> checkpoint
manager, with the preemption guard and the straggler monitor.

Usage (CPU, smoke config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --steps 20
On the card (``--device cuda``, the default) the step's attention is
the flash-attention kernel and its loss the cross-entropy kernel.

On a (data, model) mesh, one process a rank under torchrun (the
reference's ``--mesh 4x2``; the groups from torchrun's environment,
``comm.Group.from_env``, as ``launch.serve --tp`` builds them):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
      --device cpu --mesh 2x2
The world size must be D x M.  Each rank draws the whole host tree from
the seed (``weights.seeded_params``) and keeps its slice
(``launch.steps.TrainMesh``); the model axis splits the trunk of every
family -- dense and vlm (heads, MLP columns), moe (experts), ssm (RWKV6
heads), hybrid (RG-LRU gate blocks), encdec (the encoder's layers and
the cross-attention too) -- and the vocabulary where it divides (the
loss through the softmax-stats kernel on the rank's vocabulary slice;
one that does not, internvl2-26b's 92,553 ids at 2 or 4, stays whole on
every rank, its loss the cross-entropy kernel's), the data axis cuts the
batch's rows (a moe config's router loss over the global counts) and,
at D > 1, the weights (FSDP): a rank holds 1/D of every leaf the
reference cuts over ``data`` -- its f32 masters, AdamW's moments and
gradients -- and gathers a unit's weights as the unit runs.  Rank 0
logs; a checkpoint is written whole, by rank 0, and restores into any
mesh:
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch seamless-m4t-large-v2 --smoke \\
      --device cpu --mesh 2x2
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch import weights
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.optim import optimizer as opt_mod
from repro_torch.parallel import comm, sharding
from repro_torch.runtime.fault_tolerance import (PreemptionGuard, StepTimer,
                                                 StragglerMonitor)


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the card "
            "(pass --device cpu to run the plain kernel versions)")
    return device


def train(cfg: ModelConfig, shape: ShapeSpec, opt_cfg, *, device="cuda",
          steps: int = 20, ckpt_dir=None, ckpt_every: int = 50,
          data_cfg: Optional[DataConfig] = None, log_every: int = 10,
          log=print, mesh: Optional[steps_mod.TrainMesh] = None,
          params=None):
    """Train ``steps`` steps (from the latest checkpoint under
    ``ckpt_dir`` when there is one); returns (state, the losses of the
    steps run).  The masters are ``params`` (a whole f32 tree) or
    ``weights.seeded_params(cfg, data_cfg.seed)``, f32, on ``device``; a
    checkpoint is written every ``ckpt_every`` steps and on SIGTERM /
    SIGINT, asynchronously, and waited for at the end.

    ``mesh`` (``steps.make_mesh``): this rank's step on the mesh, on the
    mesh's device -- the masters cut to the rank's cut on the host (its
    model slice, and at D > 1 its 1/D of the data-cut leaves), the
    batch's rows the rank's data shard; the returned state is the rank's
    cut, the losses the global batch's.  A checkpoint holds the whole
    tree (``save_state``: gathered to rank 0's host and written there)
    and restores into the rank's cut."""
    device = resolve_device(device) if mesh is None else mesh.device
    data_cfg = data_cfg or DataConfig(vocab_size=cfg.vocab_size)
    given = params is not None
    if not given:
        params = weights.seeded_params(
            cfg, data_cfg.seed, "cpu" if mesh is not None else device)
    run_cfg = cfg
    D, d = 1, 0
    if mesh is not None:
        params = mesh.shard(params)
        run_cfg, D, d = mesh.cfg, mesh.plan.data, mesh.plan.d
    # the state's own masters (the update writes them in place), never
    # the caller's tensors
    params = tree_mod.map_tree(lambda _, t: torch.as_tensor(t).to(
        device, copy=given).contiguous(), params)
    state = {"params": params, "opt": opt_mod.init_state(opt_cfg, params)}
    step_fn = steps_mod.make_train_step(run_cfg, opt_cfg, mesh)
    pipe = TokenPipeline(data_cfg, cfg, shape, device, data=D, d=d)

    mgr = CheckpointManager(ckpt_dir, keep_last_k=2,
                            async_save=True) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        del state
        state = mgr.restore(start, steps_mod.train_state_struct(
            cfg, opt_cfg), device=device, cfg=cfg,
            split=None if mesh is None else mesh.split,
            dcut=None if mesh is None else mesh.dcut)
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
                save_state(mgr, step + 1, state, mesh)
            if guard.requested:
                log(f"[preempt] signal at step {step}; checkpointing")
                if mgr:
                    save_state(mgr, step + 1, state, mesh)
                break
    if mgr:
        mgr.wait()
    return state, losses


def save_state(mgr: CheckpointManager, step: int, state: dict,
               mesh: Optional[steps_mod.TrainMesh]) -> None:
    """``state`` into ``mgr`` in the whole layout: as it is on one device;
    on a mesh gathered to rank 0's host leaf by leaf
    (``sharding.gather_to_host``: the other ranks send their cuts and
    keep no gathered copy) and written by rank 0 alone."""
    if mesh is None:
        mgr.save(step, state)
        return
    whole = sharding.gather_to_host(state, mesh.full, mesh.split, mesh.dcut)
    if whole is not None:
        mgr.save(step, whole)


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
                    help="DxM: D data-parallel groups of M tensor-"
                    "parallel ranks, one process a rank under torchrun "
                    "(the world size must be D*M); at D > 1 each rank "
                    "holds 1/D of the weights the reference cuts over "
                    "data (FSDP)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernel versions)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    data, model = steps_mod.parse_mesh(args.mesh)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.shape:
        shape = SHAPES[args.shape]
    else:
        shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                  total_steps=max(args.steps, 10))
    if args.mesh is None and "WORLD_SIZE" not in os.environ:
        return train(cfg, shape, opt_cfg, device=args.device,
                     steps=args.steps, ckpt_dir=args.ckpt_dir)
    resolve_device(args.device)
    group = comm.Group.from_env(device=args.device)
    try:
        mesh = steps_mod.make_mesh(cfg, group, data, model)
        return train(cfg, shape, opt_cfg, steps=args.steps,
                     ckpt_dir=args.ckpt_dir, mesh=mesh,
                     log=print if group.rank == 0 else (lambda *a: None))
    finally:
        group.close()


if __name__ == "__main__":
    main()
