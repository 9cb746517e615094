"""search.rank_sort_ms: the ranking stage's sort a batch, in ms: the mean
over a pass of the traced batches with the program's spans on of the time
between the CUDA events of its ``search.rank.sort`` span (the stable sort
of every cluster's ranking key, inside ``search.rank``), the card's idle
time inside it included (benchmark/stages.py). None where a batch of the
pass lacks the span.

Beside it the index's cluster count is logged, and the build's split
counters where the program keeps them: past 4,096 clusters the sort
leaves the in-place radix sort for another of torch's sorts."""

import statistics

from benchmark import stages

SPAN = "search.rank.sort"


def read(ctx):
    from rabitq_tpu_torch.index.build import split_oversized_clusters

    p = stages.stage_pass(ctx)
    if p is None or any(b.get(SPAN, (0, None))[1] is None
                        for b in p.batches):
        return None
    value = statistics.fmean(b[SPAN][1] for b in p.batches)
    rank = statistics.fmean(b["search.rank"][1] for b in p.batches)
    idx = ctx.work.index
    ctx.log(f"[search.rank_sort_ms] {value:.4f} of search.rank "
            f"{rank:.4f} ms a batch; index k {idx.k}, capacity "
            f"{idx.capacity}; the build's split counters: "
            f"{vars(split_oversized_clusters) or 'none kept'}")
    return value
