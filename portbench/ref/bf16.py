"""The control's precision: every float32 tensor a torch function or
method returns is rounded to bfloat16 (kept in float32 storage, so the
reference's code runs unchanged), which computes the reference one
precision below the configuration's float32.

A rounded coordinate can index past its table (1 - 1e-6 rounds to 1). A
program computed in bfloat16 clamps such an index to the table, so the
control does too: every integer index is clamped into range before it is
used (on the card an index past a table is a device-side assert), and the
indices it moved are counted. The control runs on a few thousand lanes;
the count's host syncs are its cost alone."""

from __future__ import annotations

import sys

import torch
from torch.overrides import TorchFunctionMode

T = torch.Tensor
_DIM_ARGS = {torch.index_select, T.index_select, torch.gather, T.gather,
             torch.take_along_dim, T.take_along_dim}
_FLAT = {torch.take, T.take}


def _round(x):
    if isinstance(x, dict):
        return {k: _round(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(torch.float32) if x.dtype == torch.float32 else x
    if isinstance(x, list):
        return [_round(v) for v in x]
    if type(x) is tuple:
        return tuple(_round(v) for v in x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # namedtuple
        return type(x)(*(_round(v) for v in x))
    return x


round_bf16 = _round


def _clamped(index, size, moved: list):
    if isinstance(index, torch.Tensor) and not index.dtype.is_floating_point \
            and index.dtype != torch.bool and index.numel():
        fixed = index.clamp(-size, size - 1)
        moved[0] += int((fixed != index).sum())
        return fixed
    return index


def _clamp_indices(func, args, moved: list):
    """args with every integer index of an indexing call clamped to its table."""
    if func in (T.__getitem__, T.__setitem__):
        x, idx = args[0], args[1]
        items = idx if isinstance(idx, tuple) else (idx,)
        used = sum(0 if it is None or it is Ellipsis else
                   (it.dim() if isinstance(it, torch.Tensor) and it.dtype == torch.bool else 1)
                   for it in items)
        dim, out = 0, []
        for it in items:
            if it is Ellipsis:
                dim += x.dim() - used
            elif isinstance(it, torch.Tensor) and it.dtype == torch.bool:
                dim += it.dim()
            elif it is not None:
                if dim < x.dim():
                    it = _clamped(it, x.shape[dim], moved)
                dim += 1
            out.append(it)
        idx = tuple(out) if isinstance(idx, tuple) else out[0]
        return (x, idx) + tuple(args[2:])
    if func in _DIM_ARGS:
        x, d, index = args[0], args[1], args[2]
        return (x, d, _clamped(index, x.shape[d], moved)) + tuple(args[3:])
    if func in _FLAT:
        return (args[0], _clamped(args[1], args[0].numel(), moved)) + tuple(args[2:])
    return args


class BF16(TorchFunctionMode):
    """Every float32 result rounded to bfloat16, every index clamped."""

    def __init__(self):
        super().__init__()
        self.moved = [0]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args = _clamp_indices(func, args, self.moved)
        return _round(func(*args, **(kwargs or {})))


def control(fn, *args):
    """(fn computed in bfloat16, the indices it clamped); (None, None) where
    it raised (a control that gives no output)."""
    mode = BF16()
    try:
        with mode:
            return fn(*_round(args)), mode.moved[0]
    except (IndexError, RuntimeError) as err:
        print(f"[portbench] the control raised: {err!r}", file=sys.stderr)
        return None, None
