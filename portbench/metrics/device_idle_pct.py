"""device_idle_pct: the share of the profiled units' wall time in which no
operation ran on the card, from the profiler's trace."""


def read(ctx):
    d = ctx.get("device")
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
