"""Production meshes, as shapes: no devices, no process group.

Counterpart of ``repro.launch.mesh`` (``make_production_mesh`` :15-20),
for the dry-run (``launch.dryrun``), which walks one rank of a mesh on
the ``meta`` device.  ``single`` is one pod of 16 x 16 = 256 cards,
(data 16, model 16); ``multi`` two pods, the reference's (pod 2, data
16, model 16).  The port's meshes have only (data, model) axes, so
``multi`` folds ``pod`` into ``data``: (32, 16).  That is the same
layout, since in the reference's sharding ``pod`` carries data
parallelism and nothing else (``repro/parallel/sharding.py:3-7``).
A test mesh ``DxM`` parses through ``steps.parse_mesh``.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.launch import steps

PRODUCTION = {"single": (16, 16), "multi": (2 * 16, 16)}


def mesh_shape(name: str) -> Tuple[int, int]:
    """(data, model) of ``single``, ``multi`` or a ``DxM`` test mesh."""
    if name in PRODUCTION:
        return PRODUCTION[name]
    return steps.parse_mesh(name)
