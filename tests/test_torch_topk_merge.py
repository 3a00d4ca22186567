"""The CUDA top-k head's merge, modelled on the CPU:
``repro_torch.kernels.ref.topk_merge_tree`` runs the kernel's two passes
-- a sorted k-list per vocabulary range, then the tree of pairwise rank
merges -- and must give ``ref.topk_select`` bit for bit (values and
indices), with ties planted across lists and -inf entries; on finite
rows also the JAX package's ``repro.kernels.ref.topk_select``.  The
kernel itself is held against ``ref.topk_select`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)


def _rows(seed, b, v, *, ties, neg_inf):
    """Integer-valued rows (many equal values); ``ties`` copies each row's
    best 8 to the far half of the row, so equal values sit in different
    lists; ``neg_inf`` sets every 7th entry of row 0 and all of row 1 to
    -inf."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-20, 20, size=(b, v)).astype(np.float32)
    if ties:
        for r in range(b):
            for a in np.argsort(-x[r], kind="stable")[:8]:
                x[r, (a + v // 2) % v] = x[r, a]
    if neg_inf:
        x[0, ::7] = -np.inf
        x[1] = -np.inf
    return torch.from_numpy(x)


@pytest.mark.parametrize("n_lists", [1, 2, 3, 7, 75, 528])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_merge_tree_is_topk_select_bit_for_bit(k, n_lists):
    """Ties across lists and -inf entries; 528 lists is the H100's pass 1
    (four per SM), with 3,000 ids some ranges hold fewer than k (padded)
    or are empty."""
    x = _rows(k * n_lists, 4, 3000, ties=True, neg_inf=True)
    vals, idxs = tref.topk_merge_tree(x, k, n_lists)
    want_v, want_i = tref.topk_select(x, k)
    assert vals.dtype == torch.float32 and idxs.dtype == torch.int32
    assert torch.equal(vals, want_v) and torch.equal(idxs, want_i)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_merge_tree_matches_the_jax_selection_on_finite_rows(k):
    """Finite rows (the JAX reference repeats an id once only -inf is
    left): the model equals the JAX package's k stable selection passes."""
    x = _rows(k, 3, 5000, ties=True, neg_inf=False)
    vals, idxs = tref.topk_merge_tree(x, k, 75)
    jv, ji = jref.topk_select(jnp.asarray(x.numpy()), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ji))


def test_merge_tree_pads_only_past_the_ranges():
    """k larger than some ranges: every output id is real and distinct
    when k <= V."""
    x = _rows(0, 2, 70, ties=False, neg_inf=False)
    vals, idxs = tref.topk_merge_tree(x, 64, 33)   # ranges of 3 ids
    assert bool((idxs >= 0).all())
    assert all(len(set(r.tolist())) == 64 for r in idxs)
    assert torch.equal(vals, tref.topk_select(x, 64)[0])
