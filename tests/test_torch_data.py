"""The port's token pipeline (``repro_torch.data.pipeline``) against the
JAX package's (``repro.data.pipeline``): the same tokens, bit for bit,
from the synthetic source for several seeds and steps and from a
memmap'd ``.bin`` corpus."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

JCFG = j_smoke(J_ARCHS["qwen3-0.6b"])
TCFG = smoke_config(get_config("qwen3-0.6b"))


def _jax_batch(data_cfg, shape, step):
    from repro.configs.base import ShapeSpec as JShape

    mesh = make_host_mesh()
    pipe = jpipe.TokenPipeline(
        jpipe.DataConfig(**vars(data_cfg)), JCFG,
        JShape(shape.name, shape.seq_len, shape.global_batch, "train"),
        mesh, NamedSharding(mesh, P("data", None)))
    b = pipe.batch(step)
    return np.asarray(b["tokens"]), np.asarray(b["labels"])


@pytest.mark.parametrize("seed,vocab", [(0, 256), (3, 97), (11, 256)])
def test_hash_tokens_equal_reference(seed, vocab):
    rows = np.arange(5)
    for step in (0, 1, 17, 10_000):
        np.testing.assert_array_equal(
            tpipe._hash_tokens(seed, step, rows, 33, vocab),
            jpipe._hash_tokens(seed, step, rows, 33, vocab))


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_equal_reference(seed):
    shape = ShapeSpec("t", 24, 4, "train")
    dc = tpipe.DataConfig(seed=seed, vocab_size=TCFG.vocab_size)
    pipe = tpipe.TokenPipeline(dc, TCFG, shape, "cpu")
    for step in (0, 3, 40):
        b = pipe.batch(step)
        assert b["tokens"].dtype == torch.int32
        assert tuple(b["tokens"].shape) == (4, 24)
        want_t, want_l = _jax_batch(dc, shape, step)
        np.testing.assert_array_equal(b["tokens"].numpy(), want_t)
        np.testing.assert_array_equal(b["labels"].numpy(), want_l)
        np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(),
                                      b["labels"][:, :-1].numpy())


def test_memmap_batches_equal_reference(tmp_path):
    path = tmp_path / "corpus.bin"
    rng = np.random.default_rng(2)
    rng.integers(0, 60_000, 5_000).astype(np.uint16).tofile(path)
    shape = ShapeSpec("t", 16, 3, "train")
    dc = tpipe.DataConfig(kind="memmap", path=str(path),
                          vocab_size=TCFG.vocab_size)
    pipe = tpipe.TokenPipeline(dc, TCFG, shape, "cpu")
    for step in (0, 7):
        b = pipe.batch(step)
        want_t, want_l = _jax_batch(dc, shape, step)
        np.testing.assert_array_equal(b["tokens"].numpy(), want_t)
        np.testing.assert_array_equal(b["labels"].numpy(), want_l)
        assert int(b["tokens"].max()) < TCFG.vocab_size


def test_bad_sources_raise():
    shape = ShapeSpec("t", 8, 2, "train")
    with pytest.raises(ValueError, match="path"):
        tpipe.TokenPipeline(tpipe.DataConfig(kind="memmap"), TCFG, shape)
    with pytest.raises(ValueError, match="synthetic"):
        tpipe.TokenPipeline(tpipe.DataConfig(kind="parquet"), TCFG, shape)
