"""select_roofline: the select stage's share of its roofline, in %: the
least time the H100 needs for the selection's work over the traced
batches, over the time of the device operations whose name holds
``select_kernel`` in the profiler's trace.

The work is counted from the rows the selection is given, not from the
kernel, so it is the same for the kernel's resident and streamed
instances (the streamed one reads a row from global memory on each of its
passes): each rough value of a batch read once (4 bytes), each task's
cluster start once (4 bytes), and R (position, lower bound) pairs a query
written once (8 + 4 bytes), at the memory's peak; the selection does no
arithmetic worth a bound. A batch's row length is the search's own:
``probe`` tasks of the lane-folded width (fold depth x 128) where the
search folds the scan, else of the index's capacity, by the gate of
``index.search._estimate_candidates``, which a row filter shuts.

Beside it the share of the traced launches that ran the streamed
instance (``cuda_select_candidates.launches_streamed``) is logged.
"""

from benchmark import roofline

KERNEL = "select_kernel"
COUNTER = "cuda_select_candidates.launches"
STREAMED = "cuda_select_candidates.launches_streamed"


def select_row(index, params, filtered=False):
    """(tasks, width, R) of a query's selection row, as the search sizes
    it for a batch with a row filter or (``filtered`` false) without."""
    from rabitq_tpu_torch.consts import LANES
    from rabitq_tpu_torch.ops.scan_kernel import effective_fold

    probe = min(params.probe, index.k)
    probe -= min(params.probe_lo, probe)
    cap = index.capacity
    rerank = max(params.topk, min(params.rerank, probe * cap))
    depth = effective_fold(cap, max(1, min(2, int(params.fold_depth))))
    folded = (depth and params.select_reduce and not filtered
              and rerank <= probe * depth * LANES)
    return probe, depth * LANES if folded else cap, rerank


def read(ctx):
    t = ctx.trace
    launches = ctx.launches.get(COUNTER, 0)
    recs = [b - a for name, a, b in (t.device if t else ()) if KERNEL in name]
    if not recs or not launches:
        return None
    kernel_s = sum(recs) / len(recs) * launches / 1e6
    w = ctx.work
    tasks, width, rerank = select_row(
        w.index, w.params, getattr(w, "row_filter", None) is not None)
    nbytes = w.batches.shape[1] * (tasks * width * 4 + tasks * 4
                                   + rerank * (8 + 4))
    bound = nbytes / roofline.HBM_BYTES_PER_S * len(w.traced)
    streamed = ctx.launches.get(STREAMED)
    ctx.log(f"[select_roofline] row {tasks} x {width} = {tasks * width} "
            f"values, R {rerank}; bound {1e3 * bound / launches:.4f} ms a "
            f"batch (bytes), kernel {1e3 * kernel_s / launches:.4f} ms "
            f"({len(recs)} records, {launches} launches, "
            + ("streamed launches not counted" if streamed is None else
               f"{streamed} streamed: {100 * streamed / launches:.1f}%")
            + ")")
    return 100.0 * bound / kernel_s
