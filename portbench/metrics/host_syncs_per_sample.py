"""host_syncs_per_sample: the places per sample where the program's host
waited for the card (its host_syncs counter, every site), over the
profiled units."""

from ._program import counter


def read(ctx):
    return counter(ctx, "host_syncs")
