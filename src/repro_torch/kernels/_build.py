"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is a translation unit with a plain C interface (no
PyTorch headers; it may include the ``csrc/*.cuh`` headers), compiled for
Hopper into
``<checkout>/build/repro_torch/lib<name>-<hash>.so`` on first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu

The hash is of the source, the headers and the flags, so an edited kernel
rebuilds and an unchanged one loads the library already built.  ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("paged_attention", "fused_argmax_head", "fused_topk_head",
           "flash_attention", "online_softmax")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, extra: Sequence[str]):
    """Start ``nvcc`` for one source into a temp file; returns
    (process, temp path, final path), or None when already built."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *FLAGS, *extra, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)            # atomic: a reader never sees half a file
    return log


def build_all(names: Sequence[str] = KERNELS,
              extra: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes at once.  Returns each compiler log (empty when the library
    was already there).  ``extra`` adds flags, e.g. ``("-Xptxas", "-v")``
    to print registers and spills; they do not change the library's
    name, so pass them on a clean build."""
    started = {n: _start(n, extra) for n in names}
    logs = {}
    try:
        for n, s in started.items():
            logs[n] = "" if s is None else _finish(n, s)
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``name``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))
