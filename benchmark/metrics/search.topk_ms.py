"""search.topk_ms: the search's final top-k stage a batch, in ms: the mean
over a pass of the traced batches with the program's spans on of the time
between the CUDA events of its ``search.topk`` span (the precise count,
the top-k and, on a spilled index, the dedup by id), the card's idle time
inside the stage included (benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.read_stage(ctx, "search.topk")
