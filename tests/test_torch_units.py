"""The port's full-softmax unit ops on the CPU against the JAX package:
``softmax_stats``, ``online_softmax`` and ``softmax_xent`` (forward and
gradient) of ``repro_torch.kernels.ops`` against ``repro.kernels.ops``
with its Pallas kernels in interpret mode and against the jnp oracles of
``repro.kernels.ref``, on the same numpy inputs.

Tolerances (those of ``tests/test_kernels.py``): stats and softmax at
rtol 2e-5, atol 1e-7, rows summing to 1 within 1e-5; the cross-entropy
at rtol 2e-5, atol 1e-6; its gradient at rtol 1e-5, atol 1e-7.  The two
frameworks differ only in the order of their f32 sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-7
XENT_ATOL = 1e-6


def _x(b, v, scale, seed):
    return (np.random.default_rng(seed).standard_normal((b, v), np.float32)
            * scale)


@pytest.mark.parametrize("b,v", [(1, 129), (4, 1000), (33, 4097),
                                 (256, 512)])
def test_online_softmax_matches_jax(b, v):
    x = _x(b, v, 8.0, v)
    got = tops.online_softmax(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, v)
    pal = jops.online_softmax(jnp.asarray(x), use_pallas=True,
                              interpret=True)
    for want in (pal, jref.online_softmax(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("b,v", [(1, 129), (4, 1000), (33, 4097),
                                 (256, 512)])
def test_softmax_stats_matches_jax(b, v):
    x = _x(b, v, 8.0, v + 7)
    m, l = tops.softmax_stats(torch.from_numpy(x))
    assert m.dtype == l.dtype == torch.float32 and tuple(m.shape) == (b,)
    pm, pl = jops.softmax_stats(jnp.asarray(x), use_pallas=True,
                                interpret=True)
    rm, rl = jref.softmax_stats(jnp.asarray(x))
    for wm, wl in ((pm, pl), (rm, rl)):
        np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(wl), rtol=RTOL,
                                   atol=ATOL)


def test_softmax_stats_extreme_range():
    """Table-I-style extremes: -90 and +80 in one row, where a carry that
    is not rescaled overflows or underflows."""
    x = np.concatenate([np.full((2, 100), -90.0, np.float32),
                        np.full((2, 100), 80.0, np.float32)], axis=1)
    m, l = tops.softmax_stats(torch.from_numpy(x))
    pm, pl = jops.softmax_stats(jnp.asarray(x), use_pallas=True,
                                interpret=True)
    rm, rl = jref.softmax_stats(jnp.asarray(x))
    for wm, wl in ((pm, pl), (rm, rl)):
        np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(wl), rtol=RTOL,
                                   atol=ATOL)
    p = tops.online_softmax(torch.from_numpy(x))
    np.testing.assert_allclose(
        p.numpy(), np.asarray(jref.online_softmax(jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


def test_unit_ops_take_bf16_rows():
    """bf16 logits are widened to f32 exactly before any arithmetic, in
    both packages."""
    x = _x(12, 777, 6.0, 1)
    lab = np.random.default_rng(2).integers(0, 777, size=12)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_allclose(tops.online_softmax(tx).numpy(),
                               np.asarray(jref.online_softmax(jx)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tops.softmax_xent(tx, torch.from_numpy(lab)).numpy(),
        np.asarray(jref.fused_xent(jx, jnp.asarray(lab))), rtol=RTOL,
        atol=XENT_ATOL)


@pytest.mark.parametrize("b,v", [(4, 1000), (33, 4097), (256, 512)])
def test_softmax_xent_matches_jax(b, v):
    x = _x(b, v, 5.0, v + 1)
    lab = np.random.default_rng(v + 2).integers(0, v, size=b)
    got = tops.softmax_xent(torch.from_numpy(x), torch.from_numpy(lab))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b,)
    pal = jops.softmax_xent(jnp.asarray(x), jnp.asarray(lab), True, True)
    for want in (pal, jref.fused_xent(jnp.asarray(x), jnp.asarray(lab))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=XENT_ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_softmax_xent_grad_matches_jax(use_pallas):
    """d mean(softmax_xent) / d logits through the autograd backward
    against ``jax.grad`` of the JAX ``custom_vjp``; labels get none."""
    x = _x(8, 300, 1.0, 11)
    lab = np.arange(8) % 300
    tx = torch.from_numpy(x).requires_grad_(True)
    tlab = torch.from_numpy(lab)
    tops.softmax_xent(tx, tlab).mean().backward()
    want = jax.grad(lambda z: jops.softmax_xent(
        z, jnp.asarray(lab), use_pallas, True).mean())(jnp.asarray(x))
    assert tx.grad.dtype == torch.float32 and tlab.grad is None
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
