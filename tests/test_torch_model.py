"""The port's model (``repro_torch.weights``, ``repro_torch.models.lm``)
against the JAX package's on bridged weights, at the smoke size of
qwen3-0.6b (2 layers, d = 64, V = 256, f32): every bridged leaf equals
the JAX leaf, and prefill and ragged decode hidden states match.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve.sampler import Greedy, SoftmaxBaseline  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, np_tree, weights.from_numpy_params(np_tree, TCFG, "cpu")


def _walk(a, b, path=()):
    """Yield (path, numpy leaf, torch leaf) over two trees of one
    structure, asserting the structure matches."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            yield from _walk(a[k], b[k], path + (k,))
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _walk(x, y, path + (i,))
    else:
        yield path, a, b


def test_config_copy_matches_reference():
    assert TCFG.__class__ is not JCFG.__class__
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "activation", "qk_norm",
              "rope_theta", "tie_embeddings", "norm_eps", "dtype"):
        assert getattr(TCFG, f) == getattr(JCFG, f), f
    full = get_config("qwen3-0.6b")
    assert (full.n_layers, full.d_model, full.vocab_size,
            full.param_count()) == (
        28, 1024, 151936, J_ARCHS["qwen3-0.6b"].param_count())


def test_bridged_leaves_equal_jax(bridged):
    _, np_tree, tparams = bridged
    n = 0
    for path, a, b in _walk(np_tree, tparams):
        assert tuple(b.shape) == a.shape, path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))
        n += 1
    # embed, final_norm, ln1, ln2, 4 projections + 2 qk-norms, 3 mlp
    assert n == 13


def test_init_params_shapes_and_scales():
    """The port's own seeded init (``weights.seeded_params``): same tree
    and shapes as the JAX package's, normal times 1/sqrt(fan-in), norm
    scales zero, and the same numbers from the same seed."""
    tparams = weights.seeded_params(TCFG, 0, "cpu")
    jstruct = jax.eval_shape(lambda k: jlm.init_params(JCFG, k),
                             jax.random.PRNGKey(0))
    for path, want, leaf in _walk(jstruct, tparams):
        assert tuple(leaf.shape) == tuple(want.shape), path
        if path[-1] in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
            assert torch.count_nonzero(leaf) == 0, path
        else:
            fan_in = leaf.shape[-2] if path[-1] != "embed" else leaf.shape[-1]
            std = leaf.std().item() * np.sqrt(fan_in)
            assert 0.9 < std < 1.1, (path, std)
    again = weights.seeded_params(TCFG, 0, "cpu")
    assert all(torch.equal(a, b) for _, a, b in _walk(tparams, again))


def test_prefill_matches_jax(bridged):
    jparams, _, tparams = bridged
    rng = np.random.default_rng(1)
    toks = rng.integers(0, TCFG.vocab_size, size=(2, 11)).astype(np.int32)
    jh, jcache = jlm.prefill(jparams, JCFG, {"tokens": jnp.asarray(toks)}, 16)
    th, tcache = tlm.prefill(tparams, TCFG, torch.from_numpy(toks).long(), 16)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache[0]["slot0"]["attn"][name].numpy(),
            np.asarray(jcache[0]["slot0"]["attn"][name]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("t", [1, 4])
def test_ragged_paged_decode_matches_jax(bridged, t):
    """One paged decode step with every row at its own position (T = 1,
    (B,) positions) or a (B, T) window: hidden states and the K/V the
    step writes into the pools match the JAX package."""
    jparams, _, tparams = bridged
    rng = np.random.default_rng(2 + t)
    L, hkv, hd, bs = TCFG.n_layers, TCFG.n_kv_heads, TCFG.head_dim, 4
    b, nblocks = 3, 20
    last = np.array([1, 6, 13])
    nb = 4
    perm = rng.permutation(nblocks)
    table = np.stack([np.concatenate([perm[5 * r:5 * r + p // bs + 1],
                                      [perm[5 * r]] * (nb - p // bs - 1)])
                      for r, p in enumerate(last)]).astype(np.int32)
    kp = rng.normal(size=(L, nblocks, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(L, nblocks, bs, hkv, hd)).astype(np.float32)
    toks = rng.integers(0, TCFG.vocab_size, size=(b, t)).astype(np.int32)
    if t == 1:
        pos = last.astype(np.int32)
    else:
        pos = np.maximum(last[:, None] - np.arange(t - 1, -1, -1),
                         0).astype(np.int32)
    jcache = [{"slot0": {"attn": {"k": jnp.asarray(kp),
                                  "v": jnp.asarray(vp)}}}]
    jh, jnew = jlm.decode_step(jparams, JCFG, jnp.asarray(toks), jcache,
                               jnp.asarray(pos),
                               block_tables=jnp.asarray(table))
    pools = {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())}
    th, _ = tlm.decode_step(tparams, TCFG, torch.from_numpy(toks).long(),
                            [{"slot0": {"attn": pools}}],
                            torch.from_numpy(pos),
                            block_tables=torch.from_numpy(table))
    assert tuple(th.shape) == np.asarray(jh).shape
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            pools[name].numpy(),
            np.asarray(jnew[0]["slot0"]["attn"][name]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("head_mode", ["reduced", "softmax"])
def test_serve_steps_match_jax(bridged, head_mode):
    """``serve_prefill_paged`` writes the prompt's K/V into the slot's
    pool blocks (zero-padded to the block cover) and ``serve_decode``
    then runs a ragged step; both end in the head's token ids."""
    jparams, _, tparams = bridged
    sampler = Greedy() if head_mode == "reduced" else SoftmaxBaseline()
    rng = np.random.default_rng(9)
    L, hkv, hd, bs, nblocks = (TCFG.n_layers, TCFG.n_kv_heads,
                               TCFG.head_dim, 4, 12)
    kp = rng.normal(size=(L, nblocks, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(L, nblocks, bs, hkv, hd)).astype(np.float32)
    toks = rng.integers(0, TCFG.vocab_size, size=(1, 10)).astype(np.int32)
    blocks = np.array([7, 2, 9], np.int32)           # cover of 10 tokens
    jout, jpools, _ = japi.serve_prefill_paged(
        jparams, JCFG, {"tokens": jnp.asarray(toks)}, 12, head_mode,
        pools=[jnp.asarray(kp), jnp.asarray(vp)],
        blocks=jnp.asarray(blocks), paged_mask=(True, True))
    pools = {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())}
    tout = tapi.serve_prefill_paged(tparams, TCFG, torch.from_numpy(toks).long(),
                                    12, sampler, pools=pools,
                                    blocks=torch.from_numpy(blocks).long())
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    for name, jp in zip(("k", "v"), jpools):
        np.testing.assert_allclose(pools[name].numpy(), np.asarray(jp),
                                   atol=TOL, rtol=TOL)
    # a ragged step: row 0 continues the prompt, row 1 reuses block 2
    table = np.array([[7, 2, 9, 7], [2, 2, 2, 2]], np.int32)
    pos = np.array([10, 3], np.int32)
    tok = rng.integers(0, TCFG.vocab_size, size=(2, 1)).astype(np.int32)
    jcache = [{"slot0": {"attn": {"k": jpools[0], "v": jpools[1]}}}]
    jid, _ = japi.serve_decode(jparams, JCFG, jnp.asarray(tok), jcache,
                               jnp.asarray(pos), head_mode,
                               block_tables=jnp.asarray(table))
    tid, _ = tapi.serve_decode(tparams, TCFG, torch.from_numpy(tok).long(),
                               [{"slot0": {"attn": pools}}],
                               torch.from_numpy(pos), sampler,
                               block_tables=torch.from_numpy(table))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))


def test_bridge_rejects_wrong_trees(bridged):
    _, np_tree, _ = bridged
    bad = dict(np_tree)
    bad["embed"] = np_tree["embed"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        weights.from_numpy_params(bad, TCFG, "cpu")
    bad = dict(np_tree)
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="keys"):
        weights.from_numpy_params(bad, TCFG, "cpu")
    # a tree of another family: the encoder-decoder's wants its encoder
    with pytest.raises(ValueError, match="keys"):
        weights.from_numpy_params(
            np_tree, smoke_config(get_config("seamless-m4t-large-v2")), "cpu")
