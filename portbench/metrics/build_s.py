"""build_s: host seconds of Scene.build(device=...) in set-up, synchronised."""


def read(ctx):
    return ctx.get("build_s")
