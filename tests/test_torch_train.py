"""The port's training path (``repro_torch.models.api.train_loss``,
``launch.steps``, ``launch.train``, the flash-attention gradient, remat)
against the JAX package's on bridged weights, at smoke size in f32.

Tolerances: the loss agrees within 1e-5 absolute; each gradient leaf
within ``GRAD_TOL`` (5e-5) of its own largest |value| (the frameworks
sum in other orders; the worst leaf seen is ~7e-6, rwkv6's); five AdamW
steps' losses within 1e-5, ``grad_norm`` and ``lr`` at rtol 1e-5 and
the params and moments within ``PARAM_TOL`` (5e-5) absolute: AdamW's
step ``m / sqrt(v)`` is scale-free, so where an element's gradient is
near zero the two frameworks' rounding sets its step, which can reach
lr = 3e-3 (the worst element seen moves 1.1e-5 apart in five steps).
Checks of the port against itself (remat on and off, the flash
backward's row slices against autograd, a resumed run against an
uninterrupted one) are bitwise or within 1e-6 on the CPU, as stated in
each.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.serve.api import LLM  # noqa: E402
from repro_torch.serve.params import SamplingParams  # noqa: E402

torch.set_num_threads(2)

LOSS_TOL = 1e-5
GRAD_TOL = 5e-5
PARAM_TOL = 5e-5
ARCHS = ("qwen3-0.6b", "starcoder2-7b", "phi3.5-moe-42b-a6.6b",
         "llama4-maverick-400b-a17b", "recurrentgemma-2b", "rwkv6-7b",
         "internvl2-26b", "seamless-m4t-large-v2")
SERVED = ("qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
          "rwkv6-7b")


def _bridged(arch, seed=0):
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), smoke_config(get_config(arch))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, weights.from_numpy_params(np_tree, tcfg,
                                                          "cpu")


def _tokens(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s + 1)).astype(np.int32)


def _batches(toks, cfg=None):
    """The (JAX, port) batches of ``toks``; under ``cfg``, with the stub
    frontends' embeddings its family takes (normals from a fixed seed):
    ``src_embeds`` (B, S, D), ``image_embeds`` (B, num_image_tokens, D)."""
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    t = torch.from_numpy(toks)
    tb = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    b, s = t.shape[0], t.shape[1] - 1
    rng = np.random.default_rng(11)
    for name, n, on in (("src_embeds", s, cfg and cfg.n_encoder_layers),
                        ("image_embeds", cfg and cfg.num_image_tokens,
                         cfg and cfg.num_image_tokens)):
        if on:
            e = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
            jb[name], tb[name] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


def _walk(a, b, path=()):
    """(path, JAX numpy leaf, port leaf) over two trees of one structure."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            yield from _walk(a[k], b[k], path + (k,))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _walk(x, y, path + (i,))
    else:
        yield path, np.asarray(a), b


def _leaf_close(path, want, got, tol):
    got = got.detach().float().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1e-3), (path, err, scale)


# -- the loss and its gradient ------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_jax(arch):
    """``train_loss`` and the gradient of every leaf against
    ``jax.value_and_grad(api.train_loss)``: GLU and gelu MLPs, top-2 MoE
    with its router loss, llama4's (attn, moe) units with a shared
    expert, the RG-LRU hybrid, RWKV6, the vlm's image prefix and the
    encoder-decoder (its encoder, cross-attention and ReLU MLP).  No
    leaf's gradient is missing (``loss_and_grads`` would give zeros:
    every leaf must match JAX's)."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    jb, tb = _batches(_tokens(jcfg.vocab_size), jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(p, jcfg, jb)))(jparams)
    live = [p.requires_grad_(True) for p in tree_mod.leaves(tparams)]
    loss = tapi.train_loss(tparams, tcfg, tb)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    assert all(g is not None for g in grads)
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL
    gtree = tree_mod.unflatten(tparams, list(grads))
    for path, want, got in _walk(jax.tree.map(np.asarray, jgrads), gtree):
        _leaf_close(path, want, got, GRAD_TOL)


def test_head_gradient_keeps_the_f32_cotangent():
    """The head's ``h @ W`` in bf16 (``lm._HeadMatmul``) against the
    gradient of the JAX package's ``logits_fn``, whose transpose keeps
    the f32 output gradient in f32: dh (bf16) and the tied embedding's
    gradient (through its bf16 cast, f32) agree element for element but
    for f32 rounding flips (none seen) -- at most 1 % of elements, each
    within one bf16 step (2^-7 of its value).  Rounding the cotangent to
    bf16 first moves 44 % of dh's."""
    jcfg, tcfg, jparams, tparams = _bridged("qwen3-0.6b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    g = rng.normal(size=(2, 16, jcfg.vocab_size)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, e: jlm.logits_fn({"embed": e}, jcfg, x), jx,
                     jparams["embed"])
    want_dx, want_de = (np.asarray(a, np.float32) for a in vjp(
        jnp.asarray(g)))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    te = tparams["embed"].requires_grad_(True)
    out = tlm.logits_fn({"embed": te.to(torch.bfloat16)}, tcfg, tx)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, (tx, te), torch.from_numpy(g))
    for want, got in zip((want_dx, want_de), got):
        got = got.float().numpy()
        off = got != want
        assert off.mean() <= 0.01, off.mean()
        assert np.all(np.abs(got - want)[off]
                      <= 2.0 ** -7 * np.abs(want)[off]), "more than a step"


# a bf16 gradient against JAX's: no further from it, nor from JAX's f32
# gradient, than JAX's own bf16 gradient is from its f32 one, twice over
# (the worst leaf's error over its max |value|, seen: 0.030 and 0.041
# against 2 x 0.047 at qwen3; 0.038 and 0.041 against 2 x 0.045 at
# recurrentgemma); the losses within 2^-8 of the loss (seen: <= 3e-3)
BF16_GAP_RATIO = 2.0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b"])
def test_bf16_remat_gradients_track_jax(arch):
    """``train_loss`` and every gradient leaf in bf16 under
    ``remat="dots"`` (the full-width training configuration) against
    ``jax.value_and_grad(api.train_loss)`` in bf16 and in f32 on the same
    bridged masters and batch, at ``BF16_GAP_RATIO`` times JAX's own bf16
    error."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    jb, tb = _batches(_tokens(jcfg.vocab_size))
    jax_out = {}
    for dtype in ("float32", "bfloat16"):
        jc = dataclasses.replace(jcfg, dtype=dtype, remat="dots")
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: japi.train_loss(p, jc, jb)))(jparams)
        jax_out[dtype] = float(loss), jax.tree.map(
            lambda a: np.asarray(a, np.float32), grads)
    live = [p.requires_grad_(True) for p in tree_mod.leaves(tparams)]
    loss = tapi.train_loss(tparams, dataclasses.replace(
        tcfg, dtype="bfloat16", remat="dots"), tb)
    grads = tree_mod.unflatten(tparams, list(
        torch.autograd.grad(loss, live)))

    def worst(a, b):
        return max(float(np.abs(x - np.asarray(y.float().detach() if
                                               torch.is_tensor(y) else y))
                         .max()) / max(float(np.abs(x).max()), 1e-3)
                   for _, x, y in _walk(a, b))

    jax_gap = worst(jax_out["float32"][1], jax_out["bfloat16"][1])
    assert worst(jax_out["bfloat16"][1], grads) <= BF16_GAP_RATIO * jax_gap
    assert worst(jax_out["float32"][1], grads) <= BF16_GAP_RATIO * jax_gap
    loss = float(loss.detach())
    assert abs(loss - jax_out["bfloat16"][0]) <= 2.0 ** -8 * abs(loss)


def test_xent_loss_with_a_mask_matches_jax():
    """``xent_loss`` with a ``loss_mask``: the masked mean and its
    gradient in the logits, and an all-zero mask (divided by max(0, 1))."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 8, 256)).astype(np.float32) * 3
    labels = rng.integers(0, 256, (2, 8)).astype(np.int32)
    for mask in (rng.random((2, 8)) < 0.6, np.zeros((2, 8), bool), None):
        jm = None if mask is None else jnp.asarray(mask)
        jl, jg = jax.value_and_grad(
            lambda x: japi.xent_loss(x, jnp.asarray(labels), jm))(
                jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        tl = tapi.xent_loss(x, torch.from_numpy(labels),
                            None if mask is None else torch.from_numpy(mask))
        (g,) = torch.autograd.grad(tl, x)
        assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("arch", SERVED)
def test_train_loss_gradients_flow_everywhere(arch):
    """No dead parameters (the reference's test_system.py:71 on the
    port's seeded tree): every leaf's gradient is nonzero somewhere."""
    cfg = smoke_config(get_config(arch))
    params = weights.seeded_params(cfg, 0, "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, s=47, seed=1))
    _, grads = steps_mod.loss_and_grads(
        params, cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    dead = [tree_mod.key(p) for p, g in tree_mod.items(grads)
            if float(g.abs().max()) == 0.0]
    assert not dead, dead


# -- remat and the flash backward ---------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama4-maverick-400b-a17b",
                                  "recurrentgemma-2b"])
def test_remat_equals_no_remat(arch, monkeypatch):
    """``cfg.remat`` 'dots' gives the loss and gradients of 'none'
    bitwise on the CPU, and recomputes each unit: the attention runs
    twice a layer, once without."""
    cfg = smoke_config(get_config(arch))
    params = weights.seeded_params(cfg, 2, "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, seed=2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    calls = []
    plain = ref.flash_attention

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(ref, "flash_attention", counted)
    out = {}
    for remat in ("none", "dots"):
        calls.clear()
        out[remat] = steps_mod.loss_and_grads(
            params, dataclasses.replace(cfg, remat=remat), batch)
        out[remat + "_calls"] = len(calls)
    n_attn = tlm.kv_layers(cfg)
    assert out["none_calls"] == n_attn
    assert out["dots_calls"] == 2 * n_attn
    assert torch.equal(out["none"][0], out["dots"][0])
    for (p, a), (_, b) in zip(tree_mod.items(out["none"][1]),
                              tree_mod.items(out["dots"][1])):
        assert torch.equal(a, b), tree_mod.key(p)


@pytest.mark.parametrize("causal,window,hq,hkv", [
    (True, None, 4, 2), (True, 5, 4, 2), (False, None, 4, 4),
    (True, 3, 4, 1)])
def test_flash_backward_slices_match_autograd(causal, window, hq, hkv,
                                              monkeypatch):
    """``ops.flash_attention_backward`` -- the plain version recomputed
    over slices of query rows, each reading only the keys it sees --
    against autograd through ``ref.flash_attention`` whole, at slices of
    1 row (the bound forced down) and of every row; and the
    ``autograd.Function`` the card uses, run on CPU tensors with the
    plain version standing in for the kernel, gives the same gradient
    (f32, 1e-6)."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(2, hq, 11, 16, generator=gen)
    k = torch.randn(2, hkv, 11, 16, generator=gen)
    v = torch.randn(2, hkv, 11, 16, generator=gen)
    g = torch.randn(2, hq, 11, 16, generator=gen)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(
        ref.flash_attention(qa, ka, va, causal=causal, window=window),
        (qa, ka, va), g)
    for bound in (2 * hq * 11, ops.FLASH_BWD_SCORES):
        monkeypatch.setattr(ops, "FLASH_BWD_SCORES", bound)
        got = ops.flash_attention_backward(q, k, v, g, causal=causal,
                                           window=window)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(ops._fa, "flash_attention", ref.flash_attention)
    qf, kf, vf = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops._FlashAttention.apply(qf, kf, vf, causal, window)
    torch.testing.assert_close(out, ref.flash_attention(
        q, k, v, causal=causal, window=window), rtol=0, atol=0)
    got = torch.autograd.grad(out, (qf, kf, vf), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_kernel_entries_without_a_backward_refuse_grad():
    """The guard of every CUDA entry without a backward (paged attention,
    the heads, softmax_stats, online_softmax): it raises when grad is
    enabled and an operand requires it, and passes under ``no_grad`` or
    on operands that do not."""
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        ops._no_grad_kernel("online_softmax", x)
    with torch.no_grad():
        ops._no_grad_kernel("online_softmax", x)
    ops._no_grad_kernel("online_softmax", x.detach())


# -- the train step ----------------------------------------------------------
def test_five_train_steps_match_jax():
    """``make_train_step`` against the reference's step (value_and_grad
    + ``optimizer.update``) for five steps on the same batches: the loss,
    ``grad_norm`` and ``lr`` of every step, then every param and moment."""
    jcfg, tcfg, jparams, tparams = _bridged("qwen3-0.6b")
    opt = topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    jopt_cfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    jstate = {"params": jparams, "opt": jopt.init_state(jopt_cfg, jparams)}

    @jax.jit
    def jstep(s, b):
        loss, g = jax.value_and_grad(
            lambda p: japi.train_loss(p, jcfg, b))(s["params"])
        p, o, m = jopt.update(jopt_cfg, g, s["opt"], s["params"])
        return {"params": p, "opt": o}, dict(m, loss=loss)

    tstate = {"params": tparams, "opt": topt.init_state(opt, tparams)}
    step = steps_mod.make_train_step(tcfg, opt)
    for i in range(5):
        jb, tb = _batches(_tokens(jcfg.vocab_size, seed=10 + i))
        jstate, jm = jstep(jstate, jb)
        tstate, tm = step(tstate, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL, i
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} step {i}")
    assert int(tstate["opt"]["step"]) == 5
    assert tstate["opt"]["step"].dtype == torch.int32
    for path, want, got in _walk(jax.tree.map(np.asarray, jstate),
                                 tstate):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=PARAM_TOL, err_msg=str(path))


def test_on_grads_sees_each_steps_gradients_before_the_update():
    """``make_train_step(on_grads=)`` hands each step's gradients to the
    callback before the update reads them: the first step's are
    ``jax.grad`` of the reference's loss at the initial params (the
    update, in place on the params, leaves them as they were), and two
    steps call it twice."""
    jcfg, tcfg, jparams, tparams = _bridged("qwen3-0.6b")
    opt = topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    jb, tb = _batches(_tokens(jcfg.vocab_size, seed=10))
    want = jax.jit(jax.grad(lambda p: japi.train_loss(p, jcfg, jb)))(jparams)
    seen = []
    step = steps_mod.make_train_step(tcfg, opt, on_grads=seen.append)
    state = {"params": tparams, "opt": topt.init_state(opt, tparams)}
    for _ in range(2):
        state, _ = step(state, tb)
    assert len(seen) == 2
    for path, w, got in _walk(jax.tree.map(np.asarray, want), seen[0]):
        _leaf_close(path, w, got, GRAD_TOL)


def test_train_state_struct_is_the_reference_tree():
    """``train_state_struct`` (the meta tree ``restore`` fills) has the
    reference's leaf keys, shapes and dtypes, factored moments
    included: a checkpoint of one package names the other's leaves."""
    from repro.launch import steps as jsteps
    from repro_torch.checkpoint.manager import _flatten

    for factored in (False, True):
        opt = topt.AdamWConfig(factored=factored)
        jopt_cfg = jopt.AdamWConfig(factored=factored)
        jcfg = j_smoke(J_ARCHS["phi3.5-moe-42b-a6.6b"])
        tcfg = smoke_config(get_config("phi3.5-moe-42b-a6.6b"))
        want = {
            "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(
                jsteps.train_state_struct(jcfg, jopt_cfg))[0]}
        got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for k, t in _flatten(steps_mod.train_state_struct(
                   tcfg, opt)).items()}
        assert got == want


def test_train_resumed_equals_uninterrupted(tmp_path):
    """``train()`` 10 steps uninterrupted, against 5 steps, a checkpoint,
    and a fresh ``train()`` restoring it for 5 more (the reference's
    tests/test_distributed.py:233): losses 6-10 equal bitwise on the
    CPU."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    shape = ShapeSpec("t", 32, 4, "train")
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    quiet = lambda *a, **k: None  # noqa: E731
    _, full = train_mod.train(cfg, shape, opt, device="cpu", steps=10,
                              log=quiet)
    _, first = train_mod.train(cfg, shape, opt, device="cpu", steps=5,
                               ckpt_dir=tmp_path, ckpt_every=5, log=quiet)
    logs = []
    _, second = train_mod.train(cfg, shape, opt, device="cpu", steps=10,
                                ckpt_dir=tmp_path, ckpt_every=5,
                                log=logs.append)
    assert "[restore] resumed from step 5" in logs
    assert first == full[:5]
    assert second == full[5:]


def test_train_then_serve_reduced_equals_softmax():
    """Train 20 steps on one batch (it learns), then serve the trained
    masters through ``LLM``: the comparator head's tokens equal the
    softmax baseline's (Theorem 1 on trained weights; the reference's
    tests/test_system.py:33)."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    params = weights.seeded_params(cfg, 0, "cpu")
    opt = topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30)
    state = {"params": params, "opt": topt.init_state(opt, params)}
    toks = torch.from_numpy(_tokens(cfg.vocab_size, b=8, s=32, seed=5))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = steps_mod.make_train_step(cfg, opt)
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(20)]
    assert losses[-1] < losses[0], losses
    prompts = [toks[i, :16].tolist() for i in range(2)]
    outs = {}
    for mode in ("reduced", "softmax"):
        llm = LLM(state["params"], cfg, n_slots=2, max_len=32, eos_id=-1,
                  head_mode=mode)
        outs[mode] = [list(o.token_ids) for o in llm.generate(
            prompts, SamplingParams(max_new_tokens=5))]
    assert outs["reduced"] == outs["softmax"]


def test_cli_trains_and_refuses_a_mesh_and_a_missing_card():
    """``python -m repro_torch.launch.train``: three steps of the smoke
    config on the CPU; ``--mesh 2x1`` outside a launch of two ranks
    raises naming the world it needs (the mesh runs themselves are in
    ``tests/test_torch_tp.py``'s rank spawns); ``--device cuda`` (the
    default) raises where there is no card."""
    _, losses = train_mod.main(["--arch", "qwen3-0.6b", "--smoke",
                                "--device", "cpu", "--steps", "3",
                                "--batch", "2", "--seq", "16"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    with pytest.raises(ValueError, match="a mesh of 2x1 needs 2 ranks; "
                       "the world has 1"):
        train_mod.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                        "--mesh", "2x1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_mod.main(["--arch", "qwen3-0.6b", "--smoke"])
