"""kmeans_s: seconds of the k-means training in set-up, its row sample
included (host clock, ending in a synchronize)."""


def read(ctx):
    return ctx.setup.get("kmeans_s")
