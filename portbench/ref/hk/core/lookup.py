"""Per-lane reads from small parameter banks.

``hikari_tpu/core/lookup.py`` unrolls small-bank reads into a ``where``
chain because TPU gathers are slow; a GPU gathers natively, so the port
keeps one gather and reproduces the chain's semantics: an index outside
``[0, M)`` reads row 0 for banks of up to 16 rows, and clamps beyond that
(XLA's gather clamp).
"""

from __future__ import annotations

import torch

MAX_UNROLL = 16


def bank_lookup(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    m = arr.shape[0]
    idx = idx.long()
    if m <= MAX_UNROLL:
        idx = torch.where((idx >= 0) & (idx < m), idx, 0)
    else:
        idx = idx.clamp(0, m - 1)
    return arr[idx]
