"""Power-weighted light sampling: Walker alias table (host numpy).

Port of ``hikari_tpu/lights/sampler.py`` (light-sampler.jl:29-278) for the
point and area lights of the main path.
"""

from __future__ import annotations

import numpy as np

FOUR_PI = 4.0 * np.pi


def build_alias_table(weights: np.ndarray):
    """Walker/Vose alias table: (pmf, q, alias); sample i = floor(u n) and
    take alias[i] when frac(u n) >= q[i]."""
    w = np.asarray(weights, np.float64)
    n = len(w)
    if n == 0:
        return (np.zeros(0, np.float32),) * 3
    total = w.sum()
    pmf = np.full(n, 1.0 / n) if total <= 0.0 else w / total
    q = pmf * n
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if q[i] < 1.0]
    large = [i for i in range(n) if q[i] >= 1.0]
    while small and large:
        s = small.pop()
        big = large.pop()
        alias[s] = big
        q[big] = q[big] - (1.0 - q[s])
        (large if q[big] >= 1.0 else small).append(big)
    for i in small + large:
        q[i] = 1.0
    return pmf.astype(np.float32), q.astype(np.float32), alias


def light_powers(flat_types, flat_idx, *, point_i=None, area_le=None,
                 area_area=None, area_two_sided=None) -> np.ndarray:
    """Total emitted power per flat light (pbrt-v4 conventions); only the
    relative magnitudes matter."""
    from .types import AREA, POINT

    phi = np.zeros(len(flat_types), np.float64)
    for k, (t, i) in enumerate(zip(flat_types, flat_idx)):
        t, i = int(t), int(i)
        if t == POINT:
            phi[k] = FOUR_PI * float(np.mean(point_i[i]))
        elif t == AREA:
            two = 2.0 if bool(area_two_sided[i]) else 1.0
            phi[k] = np.pi * two * float(area_area[i]) * float(np.mean(area_le[i]))
    return phi
