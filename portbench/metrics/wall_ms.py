"""wall_ms: the traced run's plain units (no stage timer, no profiler),
their whole time on the host's clock per full-frame sample: the wall time
a sample, in a cell whose end-to-end metric is another."""


def read(ctx):
    if not ctx.get("plain_samples"):
        return None
    return ctx["plain_s"] * 1e3 / ctx["plain_samples"]
