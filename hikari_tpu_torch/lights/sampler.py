"""Power-weighted light sampling: Walker alias table (host numpy).

Port of ``hikari_tpu/lights/sampler.py`` (light-sampler.jl:29-278): the
powers of every light type and the alias table the power and uniform
samplers draw from. The BVH sampler is ``bvh_sampler.py``.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2.0 * np.pi
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


def light_powers(flat_types, flat_idx, *, point_i=None, spot_i=None, spot_cos_total=None,
                 spot_cos_falloff=None, dist_l=None, area_le=None, area_area=None,
                 area_two_sided=None, env_mean_lum: float = 0.0, env_scale: float = 1.0,
                 scene_radius: float = 1.0) -> np.ndarray:
    """Total emitted power per flat light (pbrt-v4 conventions, the
    reference's estimate_powers_kernel!); only the relative magnitudes
    matter. Distant and environment lights cover a disk and a sphere of the
    scene's radius."""
    from .types import AREA, DISTANT, ENV, POINT, SPOT

    phi = np.zeros(len(flat_types), np.float64)
    r2 = float(scene_radius) ** 2
    for k, (t, i) in enumerate(zip(flat_types, flat_idx)):
        t, i = int(t), int(i)
        if t == POINT:
            phi[k] = FOUR_PI * float(np.mean(point_i[i]))
        elif t == SPOT:
            cf, ct = float(spot_cos_falloff[i]), float(spot_cos_total[i])
            phi[k] = TWO_PI * float(np.mean(spot_i[i])) * ((1.0 - cf) + (cf - ct) * 0.5)
        elif t == DISTANT:
            phi[k] = np.pi * r2 * float(np.mean(dist_l[i]))
        elif t == AREA:
            two = 2.0 if bool(area_two_sided[i]) else 1.0
            phi[k] = np.pi * two * float(area_area[i]) * float(np.mean(area_le[i]))
        elif t == ENV:
            phi[k] = FOUR_PI * np.pi * r2 * env_mean_lum * env_scale
    return phi
