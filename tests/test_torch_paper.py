"""The paper's experiments on the port (``repro_torch.paper``) against the
JAX scripts they port: ``benchmarks/table1.py``,
``benchmarks/fig23_monotonicity.py`` and ``examples/classifier_demo.py``,
loaded from their files and run as they stand.

Tolerances: Table I's inputs are bit for bit (``prng.uniform`` is
``jax.random.uniform``); e^x and s(x) within 4 f32 ulps of the JAX
values at their scale (rtol 5e-7, plus atol 1e-44 for s(x) underflowing
to denormals in the all-negative regime) -- the two frameworks' exp and
sums round apart in the last bits.  The classifier, handed the JAX
script's data and initial weights, ends 200 SGD steps within 1e-6 of
JAX's loss (f32 rounding compounded over 200 steps of two frameworks'
matmuls and reductions; measured 7e-9 on a loss of 0.0037).
"""
import contextlib
import importlib.util
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.paper import classifier, fig23, table1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(
        "ref_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_table1():
    with contextlib.redirect_stdout(io.StringIO()):
        return _load("benchmarks/table1.py").run(verbose=False)


def test_table1_matches_the_jax_script(jax_table1):
    got = table1.run(device="cpu", verbose=False)
    assert [r[0] for r in got] == [r[0] for r in jax_table1]
    for (name, x, e, s, agree), (_, jx, je, js, jagree) in zip(got,
                                                              jax_table1):
        np.testing.assert_array_equal(x, jx, err_msg=name)
        np.testing.assert_allclose(e, je, rtol=5e-7, atol=0, err_msg=name)
        np.testing.assert_allclose(s, js, rtol=5e-7, atol=1e-44,
                                   err_msg=name)
        assert agree == jagree is True
    assert table1.csv_line(got) == "table1,0,all_regimes_argmax_preserved=True"


def test_fig23_flags_match_the_jax_script():
    with contextlib.redirect_stdout(io.StringIO()):
        want = _load("benchmarks/fig23_monotonicity.py").run(verbose=False)
    got = fig23.run(device="cpu", verbose=False)
    assert got == want and all(got.values())
    assert fig23.csv_line(got) == "fig23,0,monotone_all=True"


def _jax_classifier():
    """The JAX script's data, initial weights and 200-step training, as
    its ``main`` builds them (its ``make_data``, its formulas)."""
    demo = _load("examples/classifier_demo.py")
    key = jax.random.PRNGKey(0)
    centers = jax.random.normal(jax.random.fold_in(key, 99), (10, 32)) * 2.0
    xtr, ytr = demo.make_data(key, 2000, centers)
    xte, yte = demo.make_data(jax.random.fold_in(key, 9), 500, centers)
    ks = jax.random.split(key, 4)
    params = {"w1": jax.random.normal(ks[0], (32, 64)) * 0.18,
              "b1": jnp.zeros(64),
              "w2": jax.random.normal(ks[1], (64, 10)) * 0.125,
              "b2": jnp.zeros(10)}
    init = {k: np.asarray(v) for k, v in params.items()}

    def logits_fn(p, x):
        return jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    def loss_fn(p, x, y):
        lo = logits_fn(p, x)
        logp = lo - jax.scipy.special.logsumexp(lo, -1, keepdims=True)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], -1))

    @jax.jit
    def step(p, x, y, lr=0.1):
        loss, g = jax.value_and_grad(loss_fn)(p, x, y)
        return jax.tree.map(lambda a, b: a - lr * b, p, g), loss

    for _ in range(200):
        params, loss = step(params, xtr, ytr)
    pred = jnp.argmax(logits_fn(params, xte), -1)
    data = {k: np.asarray(v) for k, v in
            dict(xtr=xtr, ytr=ytr, xte=xte, yte=yte).items()}
    return data, init, float(loss), float(jnp.mean(pred == yte))


def test_classifier_on_the_jax_scripts_data():
    data, init, loss, acc = _jax_classifier()
    res = classifier.run(data, init, device="cpu", verbose=False)
    assert abs(res.loss - loss) <= 1e-6, (res.loss, loss)
    assert res.agreement == 1.0
    assert res.test_accuracy == acc


def test_classifier_alone_draws_its_own_data():
    res = classifier.run(device="cpu", verbose=False, steps=20)
    assert res.agreement == 1.0 and len(res.losses) == 20
    assert res.losses[-1] < res.losses[0]
    lines = classifier.op_count_lines()
    assert lines[1] == "  softmax unit: 1000 exp, 999 add, 1000 div, 999 cmp"
    assert lines[2].startswith("  reduced unit: 0 exp, 0 add, 0 div, 999 cmp")


def test_module_prints_the_three_csv_lines():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.paper", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2",
             "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert "table1,0,all_regimes_argmax_preserved=True" in lines
    assert "fig23,0,monotone_all=True" in lines
    assert any(line.startswith("classifier,0,agreement=1.000_test_accuracy=")
               for line in lines)


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        table1.run(verbose=False)
