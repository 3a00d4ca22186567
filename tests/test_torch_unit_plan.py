"""The CUDA softmax unit's split, modelled on the CPU.

``repro_torch.kernels.online_softmax.unit_plan`` sets the launch of
``softmax_stats`` and ``online_softmax`` from shapes only: chunks of a
width fixed per dtype at absolute multiples of it (16-byte edges),
``nsplit`` from V alone, and online_softmax's route -- one cooperative
pass exactly when the B * nsplit blocks fit on the card at once, else
two launches -- checked here for the H100's 132 SMs at the kernels'
stated occupancy (4 blocks per SM; on the card the wrappers read the
device's own).

``ref.softmax_stats_split`` runs the kernels' chunked fold and
split-order merge; it must equal the JAX package's Pallas
``softmax_stats`` (interpret mode) and the port's plain
``ref.softmax_stats`` at the unit's tolerances (rtol 2e-5, atol 1e-7:
the three sum in different orders), and give a row the same bits alone
and in a batch.  The kernels themselves are held against it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.online_softmax import (  # noqa: E402
    softmax_stats as pallas_stats,
)
from repro_torch.kernels import online_softmax as osm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(2)

UNIT_RTOL, UNIT_ATOL = 2e-5, 1e-7
H100_RESIDENT = 132 * osm.MIN_BLOCKS_PER_SM
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _plan(dtype, b, v):
    """The plan on an H100 at the kernels' stated occupancy."""
    return osm.unit_plan(dtype, b, v, H100_RESIDENT)


def _rows(seed, b, v, dtype, scale=8.0):
    x = np.random.default_rng(seed).standard_normal((b, v), np.float32)
    return torch.from_numpy(x * scale).to(dtype)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=UNIT_RTOL,
                               atol=UNIT_ATOL)


def _against_both(x):
    """The split model on x against the Pallas kernel (interpret mode)
    and the port's plain stats."""
    plan = _plan(x.dtype, *x.shape)
    m, l = ref.softmax_stats_split(x, plan)
    assert m.dtype == l.dtype == torch.float32
    assert tuple(m.shape) == tuple(l.shape) == (x.shape[0],)
    jx = jnp.asarray(x.float().numpy()).astype(JNP[x.dtype])
    pm, pl = pallas_stats(jx, interpret=True)
    rm, rl = ref.softmax_stats(x)
    for wm, wl in ((pm, pl), (rm, rl)):
        _close(m.numpy(), wm)
        _close(l.numpy(), wl)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_follows_the_dtype_alone(dtype):
    plans = {_plan(dtype, b, v)
             for b in (1, 12, 64, 512, 70000) for v in (1, 777, 4097, 151936)}
    assert {(p.chunk, p.vec) for p in plans} == {
        (osm.CHUNK, 16 // dtype.itemsize)}
    assert osm.CHUNK == osm.THREADS * osm.PER_THREAD == 4096
    assert osm.PER_THREAD % (16 // dtype.itemsize) == 0   # whole loads


@pytest.mark.parametrize("v,nsplit", [(1, 1), (777, 1), (4096, 1),
                                      (4097, 2), (151936, 38),
                                      (256000, 63)])
def test_nsplit_follows_v_alone(v, nsplit):
    got = {osm.unit_plan(dt, b, v, resident).nsplit
           for dt in DTYPES for b in (1, 12, 64, 512)
           for resident in (66 * 3, H100_RESIDENT, 132 * 8)}
    assert got == {nsplit}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("v", [777, 4097, 8193, 151936])
def test_chunk_edges_fall_on_16_byte_boundaries(dtype, v):
    plan = _plan(dtype, 3, v)
    edges = [s * plan.chunk for s in range(plan.nsplit)] + [v]
    assert all(e * dtype.itemsize % 16 == 0 for e in edges[:-1])
    assert edges == sorted(edges) and edges[-2] < v <= plan.nsplit * plan.chunk
    # a thread's 16-byte loads tile its chunk with no gap or overlap
    per_load = [(j * osm.THREADS + t) * plan.vec
                for j in range(osm.PER_THREAD // plan.vec)
                for t in range(osm.THREADS)]
    assert sorted(per_load) == list(range(0, plan.chunk, plan.vec))


@pytest.mark.parametrize("dtype,b,v,route", [
    (torch.float32, 12, 151936, osm.ONE_PASS),       # the unit path
    (torch.float32, 1, 151936, osm.ONE_PASS),
    (torch.float32, 64, 151936, osm.TWO_LAUNCH),
    (torch.bfloat16, 512, 151936, osm.TWO_LAUNCH),
    (torch.float32, 70000, 1000, osm.TWO_LAUNCH),    # past grid.y
    (torch.float16, 12, 777, osm.ONE_PASS),
])
def test_route_at_the_h100s_occupancy(dtype, b, v, route):
    assert _plan(dtype, b, v).route == route


@pytest.mark.parametrize("v", [777, 4097, 151936, 256000])
@pytest.mark.parametrize("resident", [H100_RESIDENT, 132 * 8, 66 * 3])
def test_route_is_one_pass_exactly_when_the_blocks_fit(v, resident):
    nsplit = -(-v // osm.CHUNK)
    edge = resident // nsplit           # the most rows that fit
    for b in (1, edge - 1, edge, edge + 1, 4 * edge):
        if b < 1:
            continue
        plan = osm.unit_plan(torch.float32, b, v, resident)
        assert (plan.route == osm.ONE_PASS) == (b * nsplit <= resident)
    assert osm.unit_plan(torch.float32, edge, v, resident
                         ).route == osm.ONE_PASS
    assert osm.unit_plan(torch.float32, edge + 1, v, resident
                         ).route == osm.TWO_LAUNCH


def test_unit_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="dtype"):
        _plan(torch.float64, 2, 10)
    with pytest.raises(ValueError, match=r"\(B, V\)"):
        _plan(torch.float32, 0, 10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 5, 12])
@pytest.mark.parametrize("v", [777, 4097, 151936])
def test_split_model_matches_jax_and_plain(dtype, b, v):
    _against_both(_rows(b * v, b, v, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [200, 9001])
def test_split_model_extreme_range(dtype, v):
    """-90 and +80 in one row (a carry that is not rescaled over- or
    underflows); at V 9001 the -90s fill the first chunk and the +80s
    the rest, so the merge carries a chunk at exp(-170)."""
    x = torch.full((3, v), -90.0)
    x[:, v // 2:] = 80.0
    x[1, 0] = 80.0
    _against_both(x.to(dtype))


def test_split_model_all_minus_inf_chunk():
    """A chunk of masked logits (-inf) merges as the empty pair."""
    x = _rows(3, 4, 9001, torch.float32)
    x[:, :osm.CHUNK] = -torch.inf
    x[2, osm.CHUNK:2 * osm.CHUNK] = -torch.inf
    plan = _plan(x.dtype, *x.shape)
    m, l = ref.softmax_stats_split(x, plan)
    rm, rl = ref.softmax_stats(x)
    _close(m.numpy(), rm.numpy())
    _close(l.numpy(), rl.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [4097, 151936])
def test_split_model_row_bits_alone_and_in_a_batch(dtype, v):
    x = _rows(v, 12, v, dtype)
    m, l = ref.softmax_stats_split(x, _plan(dtype, 12, v))
    for r in (0, 5, 11):
        m1, l1 = ref.softmax_stats_split(x[r:r + 1],
                                         _plan(dtype, 1, v))
        assert torch.equal(m1, m[r:r + 1]) and torch.equal(l1, l[r:r + 1])
    big = torch.cat([x, _rows(v + 1, 52, v, dtype)])   # B 64: two-launch
    bm, bl = ref.softmax_stats_split(big, _plan(dtype, 64, v))
    assert torch.equal(bm[:12], m) and torch.equal(bl[:12], l)
