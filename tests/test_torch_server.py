"""The port's front door on the CPU: the SSE HTTP server
(``repro_torch.serve.server``, a copy of ``repro.serve.server``),
``LLM.stats_payload`` and the CLI (``repro_torch.launch.serve``).

  - the HTTP round trip of ``tests/test_serve_api.py``: streamed equals
    non-streamed equals the JAX package's ``LLM.generate`` on bridged
    weights, ``/v1/stats`` in the reference's shape with ``host_syncs``
    and ``tokens_per_dispatch``, ``/healthz``, JSON 404 and 400s -- on a
    one-step engine and on a ``host_stride`` engine;
  - ``stats_payload`` carries every key of the JAX package's;
  - the CLI's ``main()`` in-process at ``--device cpu --host-stride 4``
    (and its batch run's tokens are stride-invariant), the modes the port
    does not serve refused, and ``--device cuda`` refused without a
    card.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.api import LLM as JLLM  # noqa: E402
from repro.serve.params import SamplingParams as JSP  # noqa: E402
from repro.serve.server import params_from_json as j_params_from_json  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.serve.api import LLM as TLLM  # noqa: E402
from repro_torch.serve.params import SamplingParams as TSP  # noqa: E402
from repro_torch.serve.server import make_server, params_from_json  # noqa: E402

torch.set_num_threads(2)

JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))
PROMPT = [5, 11, 7, 3, 19, 2]


@pytest.fixture(scope="module")
def bridged():
    jparams = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    return jparams, weights.from_numpy_params(np_tree, TCFG, "cpu")


@pytest.fixture(scope="module")
def jax_tokens(bridged):
    """The JAX facade's greedy and seeded-temperature tokens for PROMPT,
    keyed (``host_stride=1``; greedy draws nothing, so those are the
    one-step engine's too)."""
    llm = JLLM(bridged[0], JCFG, n_slots=2, max_len=64, eos_id=-1,
               host_stride=1)
    return {kind: list(llm.generate(PROMPT, JSP(**kw))[0].token_ids)
            for kind, kw in _KINDS.items()}


_KINDS = {"greedy": dict(max_new_tokens=5),
          "temperature": dict(max_new_tokens=5, head_mode="temperature",
                              temperature=0.7, seed=4)}


@pytest.mark.parametrize("host_stride", [None, 4])
def test_http_server_roundtrip(bridged, jax_tokens, host_stride):
    llm = TLLM(bridged[1], TCFG, n_slots=2, max_len=64, eos_id=-1,
               host_stride=host_stride)
    srv = make_server(llm, port=0)                # ephemeral port
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"

    def post(body):
        req = urllib.request.Request(
            f"{base}/v1/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=300)

    try:
        full = json.loads(post({"prompt": PROMPT,
                                "max_new_tokens": 5}).read())
        assert len(full["token_ids"]) == 5
        assert full["finish_reason"] == "length"
        assert full["timing"]["tok_s"] > 0
        raw = post({"prompt": PROMPT, "max_new_tokens": 5,
                    "stream": True}).read().decode()
        lines = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
        assert lines[-1] == "[DONE]"
        chunks = [json.loads(ln) for ln in lines[:-1]]
        assert [c["token"] for c in chunks] == full["token_ids"]
        assert chunks[-1]["finish_reason"] == "length"
        assert full["token_ids"] == jax_tokens["greedy"]
        stats = json.loads(urllib.request.urlopen(
            f"{base}/v1/stats", timeout=60).read())
        eng = stats["engine"]
        assert eng["host_syncs"] == eng["prefills"] + eng["decode_steps"]
        assert eng["tokens_per_dispatch"] == pytest.approx(
            eng["emitted_tokens"] / eng["host_syncs"])
        assert eng["emitted_tokens"] == 10
        if host_stride is None:
            assert eng["decode_steps"] == eng["iterations"]
        else:
            assert eng["tokens_per_dispatch"] > 2.0
        assert stats["kv"]["blocks_free"] == stats["kv"]["num_blocks"]
        assert stats["replicas"][0]["engine"] == eng
        health = json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=60).read())
        assert health["ok"] is True and health["pumping"] is True
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/no/such", timeout=60)
        assert e.value.code == 404
        assert "error" in json.loads(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            post({"prompt": "not token ids"})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            post({"prompt": PROMPT, "stream": True, "top_k": 500})
        assert e.value.code == 400
        if host_stride is not None:
            # spec_k is refused on a host_stride engine: a clean 400
            with pytest.raises(urllib.error.HTTPError) as e:
                post({"prompt": PROMPT, "spec_k": 2})
            assert e.value.code == 400
    finally:
        srv.shutdown()
        llm.stop_pump()


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_keyed_engine_serves_jax_tokens(bridged, jax_tokens, kind):
    """A ``host_stride`` LLM's greedy and seeded temperature streams: the
    same at stride 1 and 4, and the JAX facade's keyed tokens."""
    outs = []
    for stride in (1, 4):
        llm = TLLM(bridged[1], TCFG, n_slots=2, max_len=64, eos_id=-1,
                   host_stride=stride)
        outs.append(list(llm.generate(PROMPT, TSP(**_KINDS[kind]))[0]
                         .token_ids))
    assert outs[0] == outs[1] == jax_tokens[kind]


def test_stats_payload_has_the_reference_keys(bridged):
    jllm = JLLM(bridged[0], JCFG, n_slots=2, max_len=64, eos_id=-1,
                host_stride=2)
    tllm = TLLM(bridged[1], TCFG, n_slots=2, max_len=64, eos_id=-1,
                host_stride=2)
    want, got = jllm.stats_payload(), tllm.stats_payload()
    assert set(got) == set(want)
    assert set(want["engine"]) <= set(got["engine"])
    assert set(want["kv"]) <= set(got["kv"])
    assert set(got["replicas"][0]) == set(want["replicas"][0])
    json.dumps(got)                               # JSON-ready


@pytest.mark.parametrize("body", [
    {"prompt": [1], "max_new_tokens": 3, "temperature": 0.5, "top_k": 4,
     "seed": 7, "stop": [[3, 4]]},
    {"prompt": [1], "head_mode": "temperature", "n_candidates": 0},
    {"prompt": [1], "spec_k": 2, "prefix_cache": False},
])
def test_params_from_json_matches_reference(body):
    got, want = params_from_json(body), j_params_from_json(body)
    for field in ("max_new_tokens", "temperature", "top_k", "seed", "stop",
                  "head_mode", "n_candidates", "spec_k", "prefix_cache",
                  "attn_approx"):
        assert getattr(got, field) == getattr(want, field)


def _cli(*flags):
    return cli.main(["--arch", "qwen3-0.6b", "--smoke", *flags])


def test_cli_main_host_stride_on_cpu():
    """``python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke
    --device cpu --host-stride 4``, in-process: every request served, one
    sync per dispatch, several tokens a dispatch."""
    snap = _cli("--device", "cpu", "--host-stride", "4")
    assert snap["completed"] == 8 and snap["queue_depth"] == 0
    assert snap["host_syncs"] == snap["prefills"] + snap["decode_steps"]
    assert snap["emitted_tokens"] == 8 * 8
    assert snap["tokens_per_dispatch"] > 2.0
    one = _cli("--device", "cpu", "--host-stride", "1")
    assert one["emitted_tokens"] == snap["emitted_tokens"]
    assert one["decode_steps"] > snap["decode_steps"]


@pytest.mark.parametrize("flags", [
    ("--top-k", "4", "--temperature", "0.8", "--chunk-size", "8"),
    ("--head-mode", "softmax", "--attn-approx", "pseudo"),
    ("--spec-k", "3"),
    ("--kv-layout", "dense", "--top-k", "4"),
    ("--scheduler", "cohort", "--kv-layout", "dense"),
])
def test_cli_serves_its_modes_on_cpu(flags):
    snap = _cli("--device", "cpu", "--requests", "4", "--slots", "2",
                *flags)
    assert snap["completed"] == 4


# each mode the CLI once refused: the sharded head is served over a
# group of one rank outside torchrun (the trunk whole, the head's (val,
# idx) combine over one slice); --replicas through the Router; --tp is
# served under torchrun (tests/test_torch_tp.py), the HTTP frontend
# under --tp too: outside torchrun its group is one rank, which --tp 2
# refuses before anything binds
@pytest.mark.parametrize("flags", [
    ("--head-mode", "sharded"), ("--tp", "2"), ("--replicas", "2")])
def test_cli_refuses_unported_modes(flags):
    if "--tp" in flags:
        with pytest.raises(ValueError, match="process group of world 2"):
            _cli("--device", "cpu", *flags, "--serve-http", "0")
        return
    snap = _cli("--device", "cpu", "--requests", "4", "--slots", "2",
                *flags)
    assert snap["completed"] == 4 and snap["queue_depth"] == 0


def test_cli_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _cli("--requests", "1")
