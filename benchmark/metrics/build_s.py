"""build_s: seconds of ``build_index`` in set-up (host clock, ending in
a synchronize)."""


def read(ctx):
    return ctx.setup.get("build_s")
