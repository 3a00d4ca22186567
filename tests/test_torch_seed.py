"""One seed gives one model on every path of the port.

``weights.seeded_params`` draws every leaf on the host from the seed and
moves it to its device, so ``LLM.from_arch``, the CLI (``--head-mode
reduced`` and ``--head-mode sharded`` on a one-rank group), ``--tp``'s
ranks and ``Router.from_arch`` serve the same tree -- as the reference
draws one ``jax.random.PRNGKey(seed)`` tree whatever the tp
(``repro/serve/api.py``).  The tests marked ``cuda`` hold the card to the
same rule and skip where CUDA is absent.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.serve.api import LLM  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.router import Router  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.weights import seeded_params  # noqa: E402

ARCH = "qwen3-0.6b"
CLI = ["--arch", ARCH, "--smoke", "--requests", "3", "--slots", "2",
       "--max-len", "48", "--max-new", "4", "--seed", "5"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _assert_same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for path, x in la.items():
        y = lb[path]
        assert x.shape == y.shape, path
        assert torch.equal(x.cpu(), y.cpu()), path


def _run_cli(monkeypatch, argv):
    """Run the CLI's batch; returns (the engine's params, every request's
    tokens in submit order)."""
    seen = []

    class Recording(ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.recorded = []
            seen.append(self)

        def submit(self, req):
            self.recorded.append(req)
            return super().submit(req)

    monkeypatch.setattr(cli, "ServeEngine", Recording)
    cli.main(argv)
    (eng,) = seen
    return eng.params, [list(r.generated) for r in eng.recorded]


def test_seeded_params_follow_the_seed_alone(monkeypatch):
    """The tree depends on the seed only: not on how many threads draw
    its chunks, nor on how many chunks a leaf splits into."""
    cfg = smoke_config(get_config(ARCH))
    a = seeded_params(cfg, 3, "cpu")
    monkeypatch.setattr(weights.os, "cpu_count", lambda: 1)
    _assert_same_tree(a, seeded_params(cfg, 3, "cpu"))
    monkeypatch.setattr(weights, "DRAW_CHUNK", 1000)     # several a leaf
    b = seeded_params(cfg, 3, "cpu")
    c = seeded_params(cfg, 3, "cpu")
    _assert_same_tree(b, c)
    assert not torch.equal(a["embed"], b["embed"])     # another chunking
    assert not torch.equal(b["embed"], seeded_params(cfg, 4, "cpu")["embed"])
    d = cfg.d_model
    assert abs(float(a["embed"].std()) * d ** 0.5 - 1.0) < 0.05
    assert not a["final_norm"].any()


@pytest.mark.parametrize("head_mode", ["reduced", "sharded"])
def test_cli_weights_are_from_arch_weights(monkeypatch, head_mode):
    """The CLI's engine holds ``LLM.from_arch``'s tree leaf for leaf,
    under ``--head-mode reduced`` and under ``--head-mode sharded`` (a
    one-rank group outside torchrun, the tree cut on the host)."""
    params, _ = _run_cli(monkeypatch, CLI + ["--device", "cpu",
                                             "--head-mode", head_mode])
    want = LLM.from_arch(ARCH, seed=5, device="cpu", n_slots=2, max_len=48)
    _assert_same_tree(params, want.engine.params)


def test_cli_head_modes_serve_one_model(monkeypatch):
    _, reduced = _run_cli(monkeypatch, CLI + ["--device", "cpu"])
    _, sharded = _run_cli(monkeypatch, CLI + ["--device", "cpu",
                                              "--head-mode", "sharded"])
    assert reduced == sharded and all(len(t) == 4 for t in reduced)


def test_router_and_from_arch_dtype_share_the_tree():
    cfg = smoke_config(get_config(ARCH))
    want = seeded_params(cfg, 2, "cpu")
    r = Router.from_arch(ARCH, seed=2, device="cpu", replicas=1,
                         n_slots=2, max_len=48)
    _assert_same_tree(r.replicas[0].llm.engine.params, want)
    f = LLM.from_arch(ARCH, seed=2, device="cpu", dtype="bfloat16",
                      n_slots=2, max_len=48)
    assert f.cfg.dtype == "bfloat16"
    _assert_same_tree(f.engine.params, _cast(want, torch.bfloat16))


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_tree_is_the_host_tree(dev):
    cfg = smoke_config(get_config(ARCH))
    _assert_same_tree(seeded_params(cfg, 7, dev), seeded_params(cfg, 7,
                                                                "cpu"))
    on_card = LLM.from_arch(ARCH, seed=7, device=dev, n_slots=2,
                            max_len=48)
    _assert_same_tree(on_card.engine.params, seeded_params(cfg, 7, "cpu"))


@pytest.mark.cuda
def test_cli_on_the_card_serves_one_model_in_both_head_modes(monkeypatch,
                                                             dev):
    """``--device cuda`` in f32 (the smoke config's dtype): the sharded
    head on a one-rank group and the reduced head serve the same tokens
    from the same weights."""
    p1, reduced = _run_cli(monkeypatch, CLI + ["--device", "cuda"])
    p2, sharded = _run_cli(monkeypatch, CLI + ["--device", "cuda",
                                               "--head-mode", "sharded"])
    _assert_same_tree(p1, p2)
    assert reduced == sharded and all(len(t) == 4 for t in reduced)
