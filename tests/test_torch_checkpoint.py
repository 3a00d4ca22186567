"""The port's checkpoint manager and fault-tolerance runtime
(``repro_torch.checkpoint.manager``, ``repro_torch.runtime``) against
the JAX package's: the same on-disk layout, so a checkpoint written by
either package restores in the other -- bf16 leaves included, read
without ``ml_dtypes`` -- and f32 / int32 leaves are byte-identical files
(equal ``sha``).  Restored values are compared exactly."""
import json
import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager, _to_host  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    PreemptionGuard, StepTimer, StragglerMonitor, elastic_reshard)


def _tree():
    """f32, int32, a 0-d int32 and bf16 leaves, under dicts and a list."""
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "n": {"step": np.asarray(7, np.int32),
                  "ids": np.arange(5, dtype=np.int32)},
            "layers": [rng.normal(size=(2,)).astype(np.float32),
                       rng.normal(size=(2, 2)).astype(ml_dtypes.bfloat16)]}


def _torch_tree(t):
    def leaf(_, a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return tree_mod.map_tree(leaf, t)


def _np(x) -> np.ndarray:
    """A leaf of either package as float64 numpy (bf16 read from its
    16-bit words: a tensor, an ml_dtypes array or the '|V2' array the
    reference's restore returns)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            x = x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "V":
        x = x.view(ml_dtypes.bfloat16)
    return x.astype(np.float64)


def _assert_equal_trees(want, got):
    for (p, a), (q, b) in zip(tree_mod.items(want), tree_mod.items(got)):
        assert p == q
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=str(p))
        assert _np(a).shape == _np(b).shape, p


def test_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last_k=2)
    tree = _torch_tree(_tree())
    for s in (1, 2, 3):
        mgr.save(s, tree_mod.map_tree(
            lambda _, t: t * s if t.is_floating_point() else t + s, tree))
    assert mgr.all_steps() == [2, 3]       # keep_last_k collected step 1
    got = mgr.restore(3, tree)
    assert got["w"].dtype == torch.float32
    assert got["layers"][1].dtype == torch.bfloat16
    step = got["n"]["step"]
    assert step.dtype == torch.int32 and step.dim() == 0
    torch.testing.assert_close(got["w"], tree["w"] * 3, rtol=0, atol=0)
    assert int(got["n"]["step"]) == 10
    assert isinstance(got["layers"], list)


def test_corrupted_leaf_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.ones(8)})
    leaf = next(mgr.step_dir(1).glob("leaf_*.npy"))
    leaf.write_bytes(leaf.read_bytes()[:-4] + b"XXXX")
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(1, {"a": torch.ones(8)})


def test_stale_tmp_is_ignored_and_collected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_00000007.tmp-dead").mkdir()
    assert mgr.latest_step() is None
    mgr.save(8, {"a": torch.ones(2)})
    assert mgr.latest_step() == 8
    assert not list(tmp_path.glob("*.tmp-*"))


def test_async_snapshot_is_not_torn(tmp_path):
    """An async save, then an in-place update of the CPU tensors (as the
    optimizer makes): the checkpoint holds the values at save time --
    ``tensor.numpy()`` would share the tensor's memory; the manager
    copies."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    tree = {"p": torch.arange(200_000, dtype=torch.float32),
            "b": torch.ones(64, dtype=torch.bfloat16)}
    before = tree_mod.map_tree(lambda _, t: t.clone(), tree)
    for t in tree.values():                  # the snapshot is a copy
        assert not np.shares_memory(_to_host(t)[0],
                                    t.view(torch.int16).numpy()
                                    if t.dtype == torch.bfloat16
                                    else t.numpy())
    mgr.save(1, tree)
    tree["p"].add_(1.0)
    tree["b"].mul_(3)
    mgr.wait()
    _assert_equal_trees(before, mgr.restore(1, tree))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    want = _tree()
    JManager(tmp_path / "j").save(4, jax.tree.map(jnp.asarray, want))
    got = CheckpointManager(tmp_path / "j").restore(4, _torch_tree(want))
    _assert_equal_trees(want, got)


def test_port_checkpoint_restores_in_jax_with_equal_files(tmp_path):
    """The port's files restore in the JAX package; f32 and int32 leaves
    are the reference's bytes (equal sha), and the bf16 leaf's file too."""
    want = _tree()
    CheckpointManager(tmp_path / "t").save(4, _torch_tree(want))
    JManager(tmp_path / "j").save(4, jax.tree.map(jnp.asarray, want))
    got = JManager(tmp_path / "t").restore(4, jax.tree.map(jnp.asarray,
                                                            want))
    _assert_equal_trees(want, got)
    mt, mj = (json.loads((tmp_path / d / "step_00000004" / "manifest.json")
                         .read_text()) for d in ("t", "j"))
    assert mt == mj
    assert mt["leaves"]["layers/1"]["dtype"] == "bfloat16"


def test_train_state_cross_reads_both_ways(tmp_path):
    """A smoke train state of each package (params and AdamW state with
    bf16 moments) restores in the other through its own struct."""
    jcfg = j_smoke(J_ARCHS["qwen3-0.6b"])
    tcfg = smoke_config(get_config("qwen3-0.6b"))
    jo = jopt.AdamWConfig(state_dtype="bfloat16")
    to = topt.AdamWConfig(state_dtype="bfloat16")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jopt.init_state(jo, jp)}
    jstate["opt"]["m"] = jax.tree.map(lambda p: (p * 0.5).astype(
        jnp.bfloat16), jp)
    JManager(tmp_path / "j").save(3, jstate)
    got = CheckpointManager(tmp_path / "j").restore(
        3, tsteps.train_state_struct(tcfg, to))
    _assert_equal_trees(jax.tree.map(np.asarray, jstate), got)

    tp = weights.seeded_params(tcfg, 1, "cpu")
    tstate = {"params": tp, "opt": topt.init_state(to, tp)}
    tstate["opt"]["step"].fill_(9)
    CheckpointManager(tmp_path / "t").save(9, tstate)
    back = JManager(tmp_path / "t").restore(
        9, jsteps.train_state_struct(jcfg, jo))
    _assert_equal_trees(back, tstate)
    assert int(back["opt"]["step"]) == 9


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0, warmup=2, log_fn=None)
    assert not any(mon.record(i, 0.1) for i in range(6))
    assert mon.record(6, 0.5)             # 5x EMA -> straggler
    assert not mon.record(7, 0.1)         # EMA not poisoned
    assert mon.straggler_steps == [6]


def test_preemption_guard_catches_sigterm():
    with PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) is not guard._handler


def test_step_timer_and_elastic_reshard():
    with StepTimer() as t:
        time.sleep(0.02)
    assert t.dt >= 0.02
    tree = {"w": np.arange(4.0, dtype=np.float32), "l": [torch.ones(2)]}
    out = elastic_reshard(tree, "cpu")
    assert isinstance(out["w"], torch.Tensor) and isinstance(out["l"], list)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
