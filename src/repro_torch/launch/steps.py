"""The train step and the train state's structure
(``repro.launch.steps``' training half).

The serve steps and the lowering helpers of the reference are XLA
tooling: the port's serving steps are ``models.api``'s, and nothing is
lowered.
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_mod
from repro_torch import weights
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.optim import optimizer as opt_mod


def loss_and_grads(params, cfg: ModelConfig, batch: dict):
    """(loss, grads): ``api.train_loss`` and its gradient in every leaf of
    ``params`` (a tree of the f32 masters, which need not require grad:
    the loss is taken on detached views of them, so the masters stay
    plain tensors an optimizer updates in place and an engine serves).
    A leaf the loss does not reach gets zeros, as ``jax.grad`` gives."""
    live = [p.detach().requires_grad_(True) for p in tree_mod.leaves(params)]
    loss = api.train_loss(tree_mod.unflatten(params, live), cfg, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), tree_mod.unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig):
    """``step(state, batch) -> (state, metrics)``: loss and gradients
    (``loss_and_grads``), then ``optimizer.update``, which writes
    ``state["params"]`` and ``state["opt"]`` in place; the metrics are
    ``loss``, ``grad_norm`` and ``lr``, f32 scalars on the device (read
    them with ``float``, which waits for the step)."""

    def train_step(state: dict, batch: dict):
        loss, grads = loss_and_grads(state["params"], cfg, batch)
        metrics = opt_mod.update(opt_cfg, grads, state["opt"],
                                 state["params"])
        return state, dict(metrics, loss=loss)

    return train_step


def train_state_struct(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig):
    """The train state's tree on the ``meta`` device (shapes and dtypes,
    no memory): the port's ``jax.eval_shape``, the target of
    ``CheckpointManager.restore``."""
    params = tree_mod.map_tree(
        lambda _, spec: torch.empty(spec[0], dtype=torch.float32,
                                    device="meta"),
        weights.param_shapes(cfg))
    return {"params": params, "opt": opt_mod.init_state(opt_cfg, params)}
