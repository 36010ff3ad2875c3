"""pairs_per_sample: (tile, treelet) pairs the traversal driver listed per
sample for the sweeps (the program's pairs_listed counter), over the
profiled units."""

from ._program import counter


def read(ctx):
    return counter(ctx, "pairs_listed")
