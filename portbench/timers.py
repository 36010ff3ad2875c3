"""Synchronising, exclusive stage timers: a frozen copy of ``StageTimers``
of ``chip_smoke.py`` at commit 5d48e3d, with the synchronisation made
optional so the same code runs in the CPU tests. ``stages`` maps a stage to
(module, function name) pairs, wrapped where the layer's callers reach them
(a module attribute looked up at call time); time in a function of another
stage called from inside one is counted in that other stage only."""

from __future__ import annotations

import time

import torch


class StageTimers:
    def __init__(self, stages, sync: bool = True):
        self.stages = stages
        self.sync = sync
        self.secs = dict.fromkeys(stages, 0.0)
        self.calls = dict.fromkeys(stages, 0)
        self.stack = []

    def _timed(self, stage, fn):
        def wrapped(*args, **kw):
            if self.sync:
                torch.cuda.synchronize()
            now = time.perf_counter()
            if self.stack:
                self.secs[self.stack[-1][0]] += now - self.stack[-1][1]
            self.stack.append([stage, now])
            self.calls[stage] += 1
            try:
                out = fn(*args, **kw)
                if self.sync:
                    torch.cuda.synchronize()
            finally:
                end = time.perf_counter()
                self.secs[stage] += end - self.stack.pop()[1]
                if self.stack:
                    self.stack[-1][1] = end
            return out
        return wrapped

    def __enter__(self):
        self.saved = []
        for stage, targets in self.stages.items():
            for module, name in targets:
                if hasattr(module, name):
                    self.saved.append((module, name, getattr(module, name)))
                    setattr(module, name, self._timed(stage, getattr(module, name)))
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)
