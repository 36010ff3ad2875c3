"""Hit records (the ``HitRecord`` of ``hikari_tpu/geometry/traverse.py``).

The skip-link BVH walk itself is not ported: on the card the packet engine
in ``wavefront.py`` is the only traversal.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class HitRecord:
    hit: torch.Tensor  # (...,) bool
    t: torch.Tensor    # (...,)
    tri: torch.Tensor  # (...,) int32 triangle id in BVH-leaf order; -1 if miss
    b1: torch.Tensor   # (...,) barycentric of p1
    b2: torch.Tensor   # (...,) barycentric of p2
