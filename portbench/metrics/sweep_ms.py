"""sweep_ms: CUDA-event ms per sample of the sweep kernels' calls in the
profiled units."""


def read(ctx):
    calls = ctx.get("sweeps")
    if not calls or not ctx.get("prof_samples"):
        return None
    return sum(c["ms"] for c in calls) / ctx["prof_samples"]
