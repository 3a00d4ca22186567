"""The CUDA cross-entropy kernel's split, modelled on the CPU.

``fused_xent`` runs on the softmax unit's chunk plan
(``online_softmax.unit_plan``: 4,096-element chunks at absolute
multiples, ``nsplit`` from V alone) in the stats kernel's launch, the
last block of a row writing ``(m + log l) - x[label]``.
``ref.fused_xent_split`` runs that chunked fold and split-order merge;
it must equal the JAX package's Pallas ``fused_xent`` (interpret mode)
and the port's plain ``ref.fused_xent`` at the unit's cross-entropy
tolerances (rtol 2e-5, atol 1e-6: the three sum in different orders, and
``m + log l - x`` cancels), with labels on chunk edges and at the row's
max, and give a row the same bits alone and in any batch.  The
autograd backward of ``ops.softmax_xent`` must equal the one-hot form
``(p - onehot) * g`` bit for bit.  The kernel itself is held against the
model on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_xent import fused_xent as pallas_xent  # noqa: E402
from repro_torch.kernels import online_softmax as osm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

UNIT_RTOL, XENT_ATOL = 2e-5, 1e-6
H100_RESIDENT = 132 * osm.MIN_BLOCKS_PER_SM
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _plan(dtype, b, v):
    """The plan on an H100 at the kernels' stated occupancy."""
    return osm.unit_plan(dtype, b, v, H100_RESIDENT)


def _rows(seed, b, v, dtype, scale=8.0):
    x = np.random.default_rng(seed).standard_normal((b, v), np.float32)
    return torch.from_numpy(x * scale).to(dtype)


def _labels(seed, b, v):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, v, b))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=UNIT_RTOL,
                               atol=XENT_ATOL)


def _against_both(x, lab):
    """The split model on (x, lab) against the Pallas kernel (interpret
    mode) and the port's plain cross-entropy."""
    loss = ref.fused_xent_split(x, lab, _plan(x.dtype, *x.shape))
    assert loss.dtype == torch.float32 and tuple(loss.shape) == (x.shape[0],)
    jx = jnp.asarray(x.float().numpy()).astype(JNP[x.dtype])
    _close(loss.numpy(), pallas_xent(jx, jnp.asarray(lab.numpy()),
                                     interpret=True))
    _close(loss.numpy(), ref.fused_xent(x, lab).numpy())
    return loss


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 5, 12])
@pytest.mark.parametrize("v", [777, 4097, 151936])
def test_xent_split_matches_jax_and_plain(dtype, b, v):
    _against_both(_rows(b * v + 1, b, v, dtype), _labels(v, b, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [4097, 9001, 151936])
def test_xent_split_labels_on_chunk_edges_and_at_the_max(dtype, v):
    """Labels at 0, the last element of the first chunk (4095), the first
    of the second (4096), V - 1 and at the row's max, where the loss is
    log l alone after m - x[label] cancels."""
    x = _rows(v + 2, 5, v, dtype)
    lab = torch.tensor([0, 4095, 4096, v - 1, 0])
    lab[4] = int(torch.argmax(x[4].float()))
    loss = _against_both(x, lab)
    m, l = ref.softmax_stats_split(x, _plan(dtype, 5, v))
    assert float(loss[4]) == float((m[4] + torch.log(l[4])) - m[4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [200, 9001])
def test_xent_split_extreme_range(dtype, v):
    """-90 and +80 in one row (a carry that is not rescaled over- or
    underflows), labels on a -90 and on a +80; at V 9001 the -90s fill
    the first chunk and the +80s the rest."""
    x = torch.full((3, v), -90.0)
    x[:, v // 2:] = 80.0
    x[1, 0] = 80.0
    _against_both(x.to(dtype), torch.tensor([0, v - 1, v // 2 - 1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [4097, 151936])
def test_xent_split_row_bits_alone_and_in_a_batch(dtype, v):
    """A row's loss is the same bits alone, in B 12 and in B 64: the
    split follows V alone and the model is elementwise across rows."""
    x = torch.cat([_rows(v, 12, v, dtype), _rows(v + 1, 52, v, dtype)])
    lab = _labels(v + 3, 64, v)
    runs = {b: ref.fused_xent_split(x[:b], lab[:b], _plan(dtype, b, v))
            for b in (12, 64)}
    for r in (0, 5, 11):
        alone = ref.fused_xent_split(x[r:r + 1], lab[r:r + 1],
                                     _plan(dtype, 1, v))
        for b in (12, 64):
            assert torch.equal(alone, runs[b][r:r + 1]), (r, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v", [(8, 300), (12, 4097)])
def test_softmax_xent_backward_equals_the_one_hot_form(dtype, b, v):
    """The autograd backward subtracts 1 at the label column of the f32
    probabilities and scales them in place; that is the same bits as
    ``(p - onehot) * g`` in f32, rounded to the logits' dtype."""
    x = _rows(b + v, b, v, dtype, scale=3.0)
    lab = _labels(b, b, v)
    g = torch.from_numpy(np.random.default_rng(v).standard_normal(
        b).astype(np.float32))
    xg = x.clone().requires_grad_(True)
    ops.softmax_xent(xg, lab).backward(g)
    p = ref.online_softmax(x)
    onehot = torch.nn.functional.one_hot(lab, v).to(p.dtype)
    want = ((p - onehot) * g[:, None]).to(dtype)
    assert xg.grad.dtype == dtype
    assert torch.equal(xg.grad, want)
