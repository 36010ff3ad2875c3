"""launches_per_sample: device kernels in the profiler's trace of the
profiled units, per sample."""


def read(ctx):
    d = ctx.get("device")
    if not d or not ctx.get("prof_samples"):
        return None
    return d["launches"] / ctx["prof_samples"]
