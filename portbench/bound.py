"""The least time the card could take for a sweep call: a frozen copy of
the BOUND arithmetic of ``chip_smoke.py`` (commit 5d48e3d) and of
``tests_from_final`` of ``hikari_tpu_torch/geometry/sweep.py`` there.

BOUND is the larger of the call's bytes (each tensor argument read once,
each output written once) over the memory rate and its operations over the
FP32 rate. Operations are the ray-triangle tests the call's own output
says it needed, times 40 FLOP a flat test (the affine form's t, u and v
are 38 FLOP of multiplies and adds, plus the divide and u + v). A
closest-hit lane needs the TREELET tests of every listed pair of its tile
whose entry distance lies below its final hit; an occlusion lane that
stays unoccluded needs those of every pair below its reach, and an
occluded one is counted as needing none (the count is a floor, so the
bound is never above the least time). Published H100 SXM peaks at 700 W."""

from __future__ import annotations

import torch

PEAK_FLOPS = 67e12   # FP32, outside the tensor cores
PEAK_BYTES = 3.35e12
TEST_FLOP = 40
RAY_TILE = 1024
TREELET = 256
COL_MASK = (1 << 8) - 1


def tests_from_final(final_bits, tn_bits, seg) -> int:
    """TREELET tests for every listed pair p and lane of its tile whose
    final bound bits (n,) lie above tn_bits[p]."""
    n_tiles = seg.numel() - 1
    bits = final_bits.view(n_tiles, RAY_TILE)
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=seg.device),
                                   (seg[1:] - seg[:-1]).long())
    total = torch.zeros((), dtype=torch.int64, device=seg.device)
    for idx in torch.arange(tn_bits.numel(), device=seg.device).split(4096):
        total += (bits[tile[idx]] > tn_bits[idx, None]).sum()
    return int(total) * TREELET


def closest_final_bits(key):
    """A closest sweep's output key -> the bound bits of each lane."""
    return key | COL_MASK


def occlusion_final_bits(occ, tmax):
    """An occlusion sweep's output -> its reach bits while unoccluded, else 0."""
    return torch.where(occ == 0, tmax, 0.0).view(torch.int32)


def call_bytes(args, outs) -> int:
    return sum(x.numel() * x.element_size() for x in (*args, *outs)
               if isinstance(x, torch.Tensor))


def bound_ms(n_bytes: int, tests: int) -> float:
    return max(n_bytes / PEAK_BYTES, tests * TEST_FLOP / PEAK_FLOPS) * 1e3
