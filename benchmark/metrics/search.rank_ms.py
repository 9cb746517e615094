"""search.rank_ms: the search's ranking stage a batch, in ms: the mean
over a pass of the traced batches with the program's spans on of the time
between the CUDA events of its ``search.rank`` span (the queries' padding
and rotation, the centroid distances and the sort that ranks the
clusters), the card's idle time inside the stage included
(benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.read_stage(ctx, "search.rank")
