"""gather_l2_roofline: the rerank gather's share of its roofline, in %:
the least time the H100 needs for the rerank's work over the traced
batches, over the time of the device operations whose name holds
``gather_l2_kernel`` in the profiler's trace.

The work of a batch, at the configuration's width D (not the index's
padded one): each distinct row its rerank positions name, read once as D
f32 values, each position and each output once (8 + 4 bytes), and the
queries once; against 3 fp32 operations an element of each position
(subtract, multiply, add). The positions are the search's own
candidates, from the program's ``estimate_candidates`` on the same batch,
under the cell's row filter where it has one.
"""

import collections

import torch

from benchmark import roofline

KERNEL = "gather_l2_kernel"
COUNTER = "cuda_gather_l2.launches"


def gather_work(index, queries, params, row_filter=None):
    """(bytes, fp32 operations) of one batch's rerank gather."""
    from rabitq_tpu_torch import estimate_candidates

    pos = estimate_candidates(index, queries, params, row_filter).pos
    n_pos = pos.numel()
    rows = int(torch.unique(pos).numel())
    dim = queries.shape[1]
    nbytes = rows * dim * 4 + n_pos * (8 + 4) + queries.shape[0] * dim * 4
    return nbytes, 3 * n_pos * dim


def read(ctx):
    t = ctx.trace
    launches = ctx.launches.get(COUNTER, 0)
    recs = [b - a for name, a, b in (t.device if t else ()) if KERNEL in name]
    if not recs or not launches:
        return None
    kernel_s = sum(recs) / len(recs) * launches / 1e6
    w = ctx.work
    bound = 0.0
    by = collections.Counter()
    for b, times in collections.Counter(w.traced).items():
        s, kind = roofline.bound_s(
            *gather_work(w.index, w.batches[b], w.params, w.row_filter),
            roofline.FP32_FLOPS_PER_S)
        bound += s * times
        by[kind] += times
    ctx.log(f"[gather_l2_roofline] bound {1e3 * bound / launches:.4f} ms a "
            f"batch ({dict(by)}), kernel {1e3 * kernel_s / launches:.4f} ms "
            f"({len(recs)} records, {launches} launches)")
    return 100.0 * bound / kernel_s
