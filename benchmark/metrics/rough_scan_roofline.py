"""rough_scan_roofline: the rough scan's share of its roofline, in %: the
least time the H100 needs for the scan's work over the traced batches,
over the time of the device operations whose name holds
``rough_scan_kernel`` in the profiler's trace.

The work is counted from the search's own probed clusters (the program's
public ``rough_scan`` on the same batch and parameters, so its ranking at
the cell's precision), at the configuration's width D (not the index's
padded one), and not from the kernel's operands, so it is the same
whatever layout or mode implements the scan:

- each distinct row of the clusters a batch probes, read once: its code
  at the index's ``code_bits * D / 8`` bytes and its four f32 factors;
- each (query, probed cluster) task's quantized query at its information
  size, 4 bits a dimension, and its four f32 scalars;
- the R candidates a query hands on, an id and an f32 estimate of 4
  bytes each, written once;
- under a row filter, each distinct probed row's f32 penalty;

against 2 * D int8 operations a scanned row of a task. The probed
clusters do not depend on the filter, so they are taken from a scan
without it; the share of the traced launches that carried a penalty
(``cuda_rough_scan.launches_penalty``) is logged.
"""

import collections

import torch

from benchmark import roofline

KERNEL = "rough_scan_kernel"
COUNTER = "cuda_rough_scan.launches"
PENALTY = "cuda_rough_scan.launches_penalty"
QUERY_BITS = 4
SCALARS = 4  # f32 factors a row, and f32 scalars a task
OUT_BYTES = 8  # id and estimate of one candidate


def probed_rows(offsets, starts, n_scanned):
    """(distinct rows, scanned rows) of the tasks whose cluster starts are
    ``starts``. An empty cluster shares its start with the next cluster
    that holds rows, and a start is taken for that one; where the search
    probed an empty cluster (its scanned rows fall short of what the starts
    name), the distinct rows are lowered by the shortfall, so the count
    never exceeds the work."""
    off = offsets.long()
    sizes = off[1:] - off[:-1]
    c = torch.searchsorted(off[:-1], starts.long().reshape(-1),
                           right=True) - 1
    slots = int(n_scanned.sum())
    excess = int(sizes[c].sum()) - slots
    return int(sizes[torch.unique(c)].sum()) - excess, slots


def scan_work(index, queries, params, row_filter=None):
    """(bytes, int8 operations) of one batch's rough scan."""
    from rabitq_tpu_torch.index.search import rough_scan

    scan = rough_scan(index, queries, params)
    rows, slots = probed_rows(index.offsets, scan.starts, scan.n_scanned)
    dim = queries.shape[1]
    per_row = (index.code_bits * dim / 8
               + 4 * (SCALARS + (row_filter is not None)))
    nbytes = (rows * per_row
              + scan.starts.numel() * (QUERY_BITS * dim / 8 + 4 * SCALARS)
              + queries.shape[0] * params.rerank * OUT_BYTES)
    return nbytes, 2 * dim * slots


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
            *scan_work(w.index, w.batches[b], w.params, w.row_filter),
            roofline.INT8_OPS_PER_S)
        bound += s * times
        by[kind] += times
    penalty = ctx.launches.get(PENALTY)
    ctx.log(f"[rough_scan_roofline] bound {1e3 * bound / launches:.4f} ms a "
            f"batch ({dict(by)}), kernel {1e3 * kernel_s / launches:.4f} ms "
            f"({len(recs)} records, {launches} launches, "
            + ("penalty launches not counted" if penalty is None else
               f"{penalty} with a penalty: {100 * penalty / launches:.1f}%")
            + ")")
    return 100.0 * bound / kernel_s
