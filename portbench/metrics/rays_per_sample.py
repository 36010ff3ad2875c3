"""rays_per_sample: rays traced per sample, camera and shadow rays (the
program's rays_traced counter, summed on the card), over the profiled
units."""

from ._program import counter


def read(ctx):
    return counter(ctx, "rays_traced")
