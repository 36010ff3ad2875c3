"""Per-lane reads from small parameter banks.

``hikari_tpu/core/lookup.py`` unrolls small-bank reads into a ``where``
chain because TPU gathers are slow; a GPU gathers natively, so the port
keeps one gather and reproduces the chain's semantics: an index outside
``[0, M)`` reads row 0 for banks of up to 16 rows, and clamps beyond that
(XLA's gather clamp).

The gather's form follows the row size. On CUDA, ``arr[idx]`` copies a
row whose size is a multiple of 16 bytes with one thread block a row
(``torch.index_select`` and ``torch.gather`` over an expanded index take
the same kernel), so a 16-byte row keeps one thread of a warp busy and a
read of millions of lanes costs one block a lane. Such rows, up to
``GATHER_ROW_BYTES``, are read as the 16-byte elements of a flat
complex128 view through a 1-D index, one thread an element; other rows
keep ``arr[idx]``. Both copy bytes, so the result is the same bits.
"""

from __future__ import annotations

import math

import torch

MAX_UNROLL = 16
GATHER_ROW_BYTES = 512
UNIT = 16  # bytes of a complex128 element


def gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` for an int64 ``idx`` of any shape whose entries lie in
    ``[0, M)``: (idx.shape + arr.shape[1:])."""
    row = arr.shape[1:]
    nbytes = math.prod(row) * arr.element_size()
    if nbytes % UNIT or nbytes > GATHER_ROW_BYTES:
        return arr[idx]
    k = nbytes // UNIT
    units = arr.reshape(arr.shape[0], -1).view(torch.complex128).reshape(-1)
    flat = idx.reshape(-1)
    if k > 1:
        flat = torch.add(torch.arange(k, device=idx.device), flat[:, None], alpha=k).reshape(-1)
    return units[flat].view(arr.dtype).reshape(idx.shape + row)


def bank_lookup(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    m = arr.shape[0]
    idx = idx.long()
    if m <= MAX_UNROLL:
        idx = torch.where((idx >= 0) & (idx < m), idx, 0)
    else:
        idx = idx.clamp(0, m - 1)
    return gather_rows(arr, idx)
