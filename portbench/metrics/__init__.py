"""Per-layer metric readers, one module per metric of BENCHMARK.json's
per_layer list, found by the metric's name. Each has read(ctx) -> float or
None, None where the traced run gave it nothing to read. ctx (built by
harness.Run.traced_window): stage_s / stage_calls / stage_wall_s /
stage_samples from the stage-timed units; plain_s / plain_samples from the
plain units (the cell's trace.plain_units, neither timer nor profiler); sweeps (one record a sweep
call: name, ms, bytes, tests, bound_ms), prof_samples and
device (busy_s, window_s, launches, breakdown) from the profiled units;
build_s from set-up."""


def stage_ms(ctx: dict, stage: str):
    """A stage's exclusive ms per full-frame sample, None where no call of
    it ran."""
    if not ctx.get("stage_calls", {}).get(stage) or not ctx.get("stage_samples"):
        return None
    return ctx["stage_s"][stage] * 1e3 / ctx["stage_samples"]
