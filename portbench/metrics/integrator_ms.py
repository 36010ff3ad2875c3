"""integrator_ms: ms per sample of the integrator and film: the stage-timed
units' wall time less every timed stage, per sample."""


def read(ctx):
    if not ctx.get("stage_samples"):
        return None
    rest = ctx["stage_wall_s"] - sum(ctx["stage_s"].values())
    return rest * 1e3 / ctx["stage_samples"]
