"""Sampling warps and tabulated distributions (port of
``hikari_tpu/sampling/distributions.py``).

The tabulated distributions are built once on the host (a light's
environment map) and sampled per lane: the marginal CDF with
``torch.searchsorted``, the conditional with one ``searchsorted`` over every
row's CDF laid end to end as int64 keys (a row's index above its values'
float32 bits), so a lane's search stays inside its row and every compare is
the float32 compare of the JAX package's bisection.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch


def concentric_sample_disk(u: torch.Tensor) -> torch.Tensor:
    """Map [0,1)^2 to the unit disk, low distortion (sampling.jl:5-30)."""
    off = 2.0 * u - 1.0
    ox, oy = off[..., 0], off[..., 1]
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (math.pi / 4.0) * (oy / torch.where(ox == 0.0, 1.0, ox)),
        (math.pi / 2.0) - (math.pi / 4.0) * (ox / torch.where(oy == 0.0, 1.0, oy)),
    )
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero[..., None], 0.0, p)


def cosine_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere around +z; pdf = cos(theta)/pi."""
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], -1)


# --- tabulated distributions -------------------------------------------------------


class _Tensors:
    def to(self, device):
        return type(self)(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


_SCAN_BLOCK = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along the last axis, rounded as the JAX
    package's ``jnp.cumsum`` on the CPU: XLA sums blocks of 16 in order,
    the blocks' totals by the same rule, and adds each block's carry to
    its in-block sums (torch.cumsum rounds otherwise, by a few ulps)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    if n <= _SCAN_BLOCK:
        acc, out = torch.zeros(lead, device=x.device), []
        for k in range(n):
            acc = acc + x[..., k]
            out.append(acc)
        return torch.stack(out, -1) if out else x.clone()
    nb = -(-n // _SCAN_BLOCK)
    padded = torch.cat([x, x.new_zeros(lead + (nb * _SCAN_BLOCK - n,))], -1)
    inner = _cumsum(padded.reshape(lead + (nb, _SCAN_BLOCK)))
    carry = torch.cat([x.new_zeros(lead + (1,)), _cumsum(inner[..., -1])[..., :-1]], -1)
    return (inner + carry[..., None]).reshape(lead + (nb * _SCAN_BLOCK,))[..., :n]


def _normalised_cdf(func: torch.Tensor):
    """(cdf with a leading 0, integral) along the last axis; a row that
    integrates to 0 gets the uniform CDF."""
    n = func.shape[-1]
    cdf = torch.cat([torch.zeros(func.shape[:-1] + (1,)), _cumsum(func) / n], -1)
    integral = cdf[..., -1]
    safe = torch.where(integral > 0.0, integral, 1.0)
    cdf = torch.where((integral > 0.0)[..., None], cdf / safe[..., None],
                      torch.linspace(0.0, 1.0, n + 1))
    return cdf, integral


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 values >= 0 (-0.0 as 0.0) as int64 keys in the same order."""
    return (x.float() + 0.0).contiguous().view(torch.int32).to(torch.int64)


def _interval(cdf_lo, cdf_hi, u):
    """Where u lies between two CDF values, 0 on a flat step."""
    return torch.where(cdf_hi > cdf_lo,
                       (u - cdf_lo) / torch.where(cdf_hi == cdf_lo, 1.0, cdf_hi - cdf_lo), 0.0)


@dataclass
class Distribution1D(_Tensors):
    """Piecewise-constant 1D distribution (sampling.jl Distribution1D)."""

    func: torch.Tensor      # (N,)
    cdf: torch.Tensor       # (N+1,)
    func_int: torch.Tensor  # ()

    @property
    def n(self):
        return self.func.shape[-1]


def make_distribution_1d(func) -> Distribution1D:
    func = torch.clamp(torch.as_tensor(func, dtype=torch.float32), min=0.0)
    cdf, integral = _normalised_cdf(func)
    return Distribution1D(func, cdf, integral)


def sample_distribution_1d(dist: Distribution1D, u: torch.Tensor):
    """(x in [0,1), pdf, index)."""
    n = dist.n
    idx = torch.clamp(torch.searchsorted(dist.cdf, u, right=True) - 1, 0, n - 1)
    x = (idx.float() + _interval(dist.cdf[idx], dist.cdf[idx + 1], u)) / n
    fi = torch.where(dist.func_int > 0.0, dist.func_int, 1.0)
    return x, dist.func[idx] / fi, idx


@dataclass
class Distribution2D(_Tensors):
    """2D piecewise-constant distribution: the marginal CDF over rows and
    a conditional CDF per row (sampling.jl Distribution2D)."""

    func: torch.Tensor      # (H, W)
    cond_cdf: torch.Tensor  # (H, W+1) conditional CDFs along x per row
    cond_int: torch.Tensor  # (H,) row integrals
    marg_cdf: torch.Tensor  # (H+1,)
    marg_int: torch.Tensor  # ()


def make_distribution_2d(func) -> Distribution2D:
    """Host build, in float32 as the JAX package's."""
    func = torch.clamp(torch.as_tensor(func, dtype=torch.float32).cpu(), min=0.0)
    cond_cdf, cond_int = _normalised_cdf(func)
    marg_cdf, marg_int = _normalised_cdf(cond_int)
    return Distribution2D(func, cond_cdf, cond_int, marg_cdf, marg_int)


def sample_distribution_2d(dist: Distribution2D, u: torch.Tensor):
    """u: (..., 2) -> (uv in [0,1)^2, pdf)."""
    h, w = dist.func.shape
    yi = torch.clamp(torch.searchsorted(dist.marg_cdf, u[..., 1].contiguous(), right=True) - 1,
                     0, h - 1)
    y = (yi.float() + _interval(dist.marg_cdf[yi], dist.marg_cdf[yi + 1], u[..., 1])) / h
    # every row's CDF in one sorted int64 key: row r's values as their
    # float32 bits (which order as the values do, all being >= 0) plus
    # r << 32, so a lane's search stays in its row and compares exactly
    rows = torch.arange(h, device=u.device, dtype=torch.int64)
    keys = (_bits(dist.cond_cdf) + (rows[:, None] << 32)).reshape(-1)
    base = yi * (w + 1)
    pos = torch.searchsorted(keys, _bits(u[..., 0]) + (yi << 32), right=True)
    xi = torch.clamp(pos - 1 - base, 0, w - 1)
    flat = dist.cond_cdf.reshape(-1)
    x = (xi.float() + _interval(flat[base + xi], flat[base + xi + 1], u[..., 0])) / w
    mi = torch.where(dist.marg_int > 0.0, dist.marg_int, 1.0)
    return torch.stack([x, y], -1), dist.func[yi, xi] / mi


def pdf_distribution_2d(dist: Distribution2D, uv: torch.Tensor):
    h, w = dist.func.shape
    xi = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    mi = torch.where(dist.marg_int > 0.0, dist.marg_int, 1.0)
    return dist.func[yi, xi] / mi
