"""Checkpointing: atomic, async, integrity-checked, on the reference's
on-disk layout (``repro.checkpoint.manager``), so the JAX package and
the port read each other's checkpoints.

Layout:
  <dir>/step_00000123.tmp-<nonce>/   written first
  <dir>/step_00000123/               atomic rename when complete
      manifest.json                {"step", "leaves": {key: {file, shape,
                                    dtype, sha}}}
      leaf_00000.npy ...           one file per leaf, numbered in the
                                   sorted order of the keys

A key is the leaf's path of dict keys and list indices joined by ``/``
(``params/decoder/0/slot0/attn/wq``, ``opt/step``).  Leaves are saved as
numpy would save the reference's arrays: f32 and int32 byte for byte (so
the ``sha`` -- the first 16 hex digits of the file's sha256 -- is the
reference's too), bf16 as ``ml_dtypes`` writes it (descr ``'<V2'``, the
raw 16-bit words; manifest dtype ``"bfloat16"``), which the port reads
back without ``ml_dtypes``.

  - a preempted writer leaves only a tmp dir, which ``restore`` never
    sees and the next save collects;
  - ``keep_last_k`` collects old steps;
  - with ``async_save`` ``save`` snapshots every leaf to host memory (a
    copy, never a view of a tensor a later step updates in place) and
    writes in a thread; ``wait()`` joins it.

On a (data, model) mesh a checkpoint is still the whole layout: the
train loop gathers the rank cuts to rank 0's host, leaf by leaf
(``parallel.sharding.gather_to_host``), and rank 0 writes
(``launch.train.save_state``), so a run of any mesh, and the JAX
package, reads it; ``restore(..., split=, dcut=)`` reads each leaf
through a memory map and keeps the rank's cut alone.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import uuid
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.parallel import sharding

# the manifest's dtype of a bf16 leaf (numpy's name of ml_dtypes' type)
_BF16 = "bfloat16"


def _flatten(tree) -> dict:
    return {tree_mod.key(p): leaf for p, leaf in tree_mod.items(tree)}


def _to_host(leaf):
    """(a C-ordered copy of ``leaf`` in host memory, its manifest dtype):
    a tensor's numpy twin, bf16 as its 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        # a C-ordered copy: .numpy() of a CPU tensor shares its memory
        arr = np.array(t.cpu().numpy(), order="C")
        return (arr.view(np.uint16), _BF16) if bf16 else (arr, str(arr.dtype))
    arr = np.array(leaf, order="C")
    return arr, str(arr.dtype)


def _save(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:              # ml_dtypes' header, raw words
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _load(path: Path, ent: dict, device, cut=None) -> torch.Tensor:
    """The leaf at ``path``; with ``cut`` (a view of the memory-mapped
    whole array -> the rank's slice of it) only that slice is read."""
    arr = np.load(path, allow_pickle=False, mmap_mode="r")
    if tuple(arr.shape) != tuple(ent["shape"]):
        raise IOError(f"{path}: shape {tuple(arr.shape)} != manifest "
                      f"{ent['shape']}")
    arr = np.array(arr if cut is None else cut(arr), order="C")
    if ent["dtype"] == _BF16:            # '|V2' words, without ml_dtypes
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


class CheckpointManager:
    def __init__(self, directory, keep_last_k: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep_last_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree) -> Path:
        # snapshot to host BEFORE going async: a copy, so an in-place
        # update of the tree after save() returns cannot reach the file
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)
        return self.step_dir(step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict):
        final = self.step_dir(step)
        tmp = self.dir / f"{final.name}.tmp-{uuid.uuid4().hex[:8]}"
        tmp.mkdir(parents=True)
        manifest = {}
        for i, (key, (arr, dtype)) in enumerate(sorted(host.items())):
            fname = f"leaf_{i:05d}.npy"
            _save(tmp / fname, arr, dtype)
            sha = hashlib.sha256((tmp / fname).read_bytes()).hexdigest()[:16]
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": dtype, "sha": sha}
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "leaves": manifest}))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
        # stale tmp dirs from crashed writers
        for t in self.dir.glob("step_*.tmp-*"):
            shutil.rmtree(t, ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(".json") or ".tmp-" in p.name:
                continue
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, device=None,
                verify: bool = True, *, cfg=None, split=None, dcut=None):
        """The checkpoint of ``step`` in the structure of ``target_tree``
        (e.g. ``launch.steps.train_state_struct``'s meta tree: only its
        structure is read), each leaf a tensor of the saved dtype on
        ``device`` (default the CPU).  A leaf whose bytes fail the
        manifest's sha raises ``IOError``.  With ``split`` (a
        ``parallel.sharding.Split`` of ``cfg``) and / or ``dcut`` (a
        ``sharding.DataCut``: FSDP) each leaf is the rank's cut
        (``sharding.shard_leaf``), taken from a memory map of the whole
        array before anything else is read or moved."""
        d = self.step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())["leaves"]

        def leaf(path, _):
            key = tree_mod.key(path)
            ent = manifest[key]
            if verify:
                raw = (d / ent["file"]).read_bytes()
                if hashlib.sha256(raw).hexdigest()[:16] != ent["sha"]:
                    raise IOError(f"checksum mismatch for {key} in {d}")
            cut = None
            if split is not None or dcut is not None:
                def cut(a, path=path):
                    return sharding.shard_leaf(path, a, cfg, split, dcut)
            return _load(d / ent["file"], ent, device, cut)

        return tree_mod.map_tree(leaf, target_tree)
