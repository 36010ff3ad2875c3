"""sweep_roofline_pct: the sweeps' summed bound (bound.py) over their summed
CUDA-event time, in percent, over the profiled units' sweep calls."""


def read(ctx):
    calls = ctx.get("sweeps")
    if not calls:
        return None
    ms = sum(c["ms"] for c in calls)
    return 100.0 * sum(c["bound_ms"] for c in calls) / ms if ms > 0 else None
