"""The port's prefill attention against the JAX package on the CPU.

``repro_torch.kernels.ops.flash_attention`` (its plain version on the
CPU) against the Pallas flash-attention kernel in interpret mode and the
jnp oracle ``repro.kernels.ref.flash_attention``, on the same numpy
inputs; then the port's ``lm.prefill`` against the JAX package's with
and without ``use_pallas`` on bridged weights, and the engine's prefill
going through the flash entry once per layer.

Tolerances: f32 inputs 2e-5 (the frameworks sum in other orders); bf16
inputs 2e-2 (both round the output to bf16, whose step is 2^-7 near 1);
prefill hidden states and cache leaves 1e-4, as for the rest of the
model (``tests/test_torch_model.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_TOL = 2e-2
PREFILL_TOL = 1e-4


def _qkv(b, hq, hkv, t, s, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, t, hd), np.float32),
            rng.standard_normal((b, hkv, s, hd), np.float32),
            rng.standard_normal((b, hkv, s, hd), np.float32))


def _both(q, k, v, *, causal, window, dtype=np.float32):
    """(port plain, Pallas interpret, jnp oracle) outputs as f32 numpy."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    pal = pallas_flash(jq, jk, jv, causal=causal, window=window,
                       interpret=True, block_t=32, block_s=128)
    want = jref.flash_attention(jq, jk, jv, causal=causal, window=window)
    return (got.float().numpy(), np.asarray(pal, np.float32),
            np.asarray(want, np.float32))


# the shapes of tests/test_flash_attention.py, plus ragged T (13, 37) and
# T > S, across g = Hq / Hkv in {1, 2, 4}
@pytest.mark.parametrize("b,hq,hkv,t,s,hd", [
    (2, 4, 2, 64, 64, 32),
    (1, 8, 8, 100, 100, 16),
    (2, 4, 1, 96, 96, 32),
    (1, 2, 2, 48, 160, 32),
    (1, 6, 3, 130, 130, 64),
    (1, 4, 1, 13, 13, 16),
    (2, 4, 2, 37, 37, 32),
    (1, 4, 2, 160, 48, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_pallas_and_oracle(b, hq, hkv, t, s, hd, causal):
    q, k, v = _qkv(b, hq, hkv, t, s, hd, seed=t * s + hq)
    got, pal, want = _both(q, k, v, causal=causal, window=None)
    np.testing.assert_allclose(got, pal, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("window", [16, 64])
@pytest.mark.parametrize("causal,t,s", [(True, 128, 128), (True, 48, 160),
                                        (False, 130, 130)])
def test_plain_flash_sliding_window(window, causal, t, s):
    """Windowed masks, including T != S (indices from 0 on both sides:
    the T = 48 queries see keys 0..47 at most) and a window without the
    causal mask (keys on both sides of the query)."""
    q, k, v = _qkv(1, 4, 2, t, s, 32, seed=window + t)
    got, pal, want = _both(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, pal, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_plain_flash_fully_masked_rows_are_zero():
    """T > S + window under a causal window: the last queries see no key
    at all and give 0, as the TPU kernel's clamped l does."""
    q, k, v = _qkv(1, 2, 1, 40, 8, 16, seed=3)
    got, pal, want = _both(q, k, v, causal=True, window=4)
    assert np.all(got[:, :, 11:] == 0.0) and np.any(got[:, :, :11] != 0.0)
    np.testing.assert_allclose(got, pal, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_plain_flash_bf16(hq, hkv):
    q, k, v = _qkv(1, hq, hkv, 64, 64, 32, seed=hq)
    got, pal, want = _both(q, k, v, causal=True, window=None, dtype="bf16")
    np.testing.assert_allclose(got, pal, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_plain_flash_takes_transposed_views():
    """The layer hands (B, T, H, hd) tensors over as transposed views:
    the result equals that of contiguous copies."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 2, 21, 21, 16, 9))
    qv, kv, vv = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert not qv.is_contiguous()
    torch.testing.assert_close(tops.flash_attention(qv, kv, vv),
                               tops.flash_attention(q, k, v), rtol=0, atol=0)


def test_flash_entry_checks_window():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 4, 4, 16, 0))
    with pytest.raises(ValueError, match="window"):
        tops.flash_attention(q, k, v, window=0)


# ---------------------------------------------------------------------------
# lm.prefill on bridged weights
# ---------------------------------------------------------------------------
JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("b,s", [(3, 20), (1, 37)])
def test_prefill_matches_jax(bridged, use_pallas, b, s):
    """Hidden states and every cache leaf of the port's prefill (flash
    entry, plain on the CPU) against the JAX package's with the XLA
    attention (``use_pallas=False``) and with its flash kernel in
    interpret mode (``use_pallas=True``)."""
    jparams, tparams = bridged
    jcfg = dataclasses.replace(JCFG, use_pallas=use_pallas)
    rng = np.random.default_rng(s)
    toks = rng.integers(0, TCFG.vocab_size, size=(b, s)).astype(np.int32)
    jh, jcache = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             48)
    th, tcache = tlm.prefill(tparams, TCFG, torch.from_numpy(toks).long(),
                             48)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=PREFILL_TOL,
                               rtol=PREFILL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache[0]["slot0"]["attn"][name].numpy(),
            np.asarray(jcache[0]["slot0"]["attn"][name]), atol=PREFILL_TOL,
            rtol=PREFILL_TOL)


def test_engine_prefill_runs_flash_once_per_layer(bridged, monkeypatch):
    """Every one-shot prefill of the engine (admission and the re-prefill
    after a forced preemption) calls the flash entry once per layer, and
    no decode step calls it; on the CPU the kernel never launches."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams

    _, tparams = bridged
    calls = []
    real = tops.flash_attention

    def counting(q, k, v, **kw):
        calls.append(q.shape[2])
        return real(q, k, v, **kw)

    monkeypatch.setattr(tlayers.ops, "flash_attention", counting)
    tfa.flash_attention.launches = 0
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, TCFG.vocab_size, size=8).astype(np.int32)
               for _ in range(3)]
    # the pool of tests/test_torch_serve.py::test_preemption_matches_jax
    llm = LLM(tparams, TCFG, n_slots=2, max_len=64, block_size=8,
              num_blocks=4)
    outs = llm.generate(prompts, SamplingParams(max_new_tokens=12))
    st = llm.stats
    assert st["preemptions"] > 0, "the pool was meant to force a preemption"
    assert len(calls) == TCFG.n_layers * st["prefills"]
    assert st["prefills"] > len(prompts)
    assert tfa.flash_attention.launches == 0
    assert all(len(o.token_ids) == 12 for o in outs)
