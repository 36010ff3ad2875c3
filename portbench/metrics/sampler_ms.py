"""sampler_ms: exclusive ms per sample of the sampler stage (stages.json), from
synchronising stage timers."""

from . import stage_ms


def read(ctx):
    return stage_ms(ctx, "sampler")
