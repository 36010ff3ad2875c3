"""traversal_self_ms: the traversal driver's spans (hikari.traversal; the
sweeps' own hikari.sweep spans excluded): self ms per sample on the card's
timeline, over the profiled units. The program's spans add no sync to the
run."""

from ._program import self_ms


def read(ctx):
    return self_ms(ctx, "traversal")
