"""search.scan_ms: the search's rough-scan stage a batch, in ms: the mean
over a pass of the traced batches with the program's spans on of the time
between the CUDA events of its ``search.scan`` span (the grouping of the
tasks that share a cluster and the rough_scan kernel), the card's idle
time inside the stage included (benchmark/stages.py)."""

from benchmark import stages


def read(ctx):
    return stages.read_stage(ctx, "search.scan")
