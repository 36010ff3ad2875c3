"""What the program's own spans and counters say about the profiled units
(``hikari_tpu_torch.utils.profiling.recorded()``: they record while the
profiler does, so only the profiled units are in the record). Per
full-frame sample of the profiled units; None where the program has no
such record (a commit before it had one), or the run no profiled units."""

# each layer's spans, as PERF.md section 3 names the layers
LAYER_SPANS = {
    "sampler": ("hikari.sampler",),
    "traversal": ("hikari.traversal",),
    "shading": ("hikari.shading",),
    "lights": ("hikari.lights",),
    "integrator": ("hikari.render", "hikari.lanes", "hikari.bounce", "hikari.film"),
}


def record(ctx: dict):
    """The program's record, read once a run (kept in ctx), or None."""
    if "program_record" not in ctx:
        try:
            from hikari_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        read = getattr(profiling, "recorded", None)
        ctx["program_record"] = read() if read is not None and ctx.get("prof_samples") else None
    return ctx["program_record"]


def self_ms(ctx: dict, layer: str):
    """The layer's spans' self ms on the card's timeline, per sample."""
    rec = record(ctx)
    if rec is None:
        return None
    spans = rec["spans"]
    got = [spans[name]["self_ms"] for name in LAYER_SPANS[layer] if name in spans]
    if not got or any(v is None for v in got):
        return None
    return sum(got) / ctx["prof_samples"]


def counter(ctx: dict, name: str):
    """A counter's total over the profiled units, per sample."""
    rec = record(ctx)
    if rec is None or name not in rec["counters"]:
        return None
    return rec["counters"][name]["total"] / ctx["prof_samples"]
