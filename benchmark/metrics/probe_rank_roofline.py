"""probe_rank_roofline: the ranking stage's top-probe selection's share of
its roofline, in %: the least time the H100 needs for its bytes over the
traced batches, over the time of the device operations whose name holds
``probe_rank_kernel`` in the profiler's trace.

The bytes are counted from the ranking's inputs and output, not from the
kernel, so they are the same for its fused and finished-key instances and
for the streamed one (which reads a row from global memory on each of its
passes): a batch's [B, K] cross term (or key) read once (4 bytes a value),
each query's norm once (4 bytes), the K centroid norms once a launch (4
bytes each), and ``probe`` cluster ids a query written (8 bytes each), at
the memory's peak; the selection does no arithmetic worth a bound. K is
the index's cluster count and ``probe`` the search's, capped at K.

Beside it the shares of the traced launches that formed the key from the
GEMM's terms (``cuda_probe_rank.launches_fused``) and that ran the
streamed instance (``.launches_streamed``) are logged.
"""

from benchmark import roofline

KERNEL = "probe_rank_kernel"
COUNTER = "cuda_probe_rank.launches"
FUSED = "cuda_probe_rank.launches_fused"
STREAMED = "cuda_probe_rank.launches_streamed"


def rank_bytes(index, params, b):
    """Bytes a launch of the ranking of a batch of ``b`` queries moves."""
    k = index.k
    probe = min(params.probe, k)
    return b * k * 4 + b * 4 + k * 4 + b * probe * 8


def read(ctx):
    t = ctx.trace
    launches = ctx.launches.get(COUNTER, 0)
    recs = [b - a for name, a, b in (t.device if t else ()) if KERNEL in name]
    if not recs or not launches:
        return None
    kernel_s = sum(recs) / len(recs) * launches / 1e6
    w = ctx.work
    nbytes = rank_bytes(w.index, w.params, w.batches.shape[1])
    bound = nbytes / roofline.HBM_BYTES_PER_S * len(w.traced)

    def share(counter):
        n = ctx.launches.get(counter)
        return ("not counted" if n is None else
                f"{n} ({100 * n / launches:.1f}%)")

    ctx.log(f"[probe_rank_roofline] K {w.index.k}, probe "
            f"{min(w.params.probe, w.index.k)}; bound "
            f"{1e3 * bound / len(w.traced):.4f} ms a batch (bytes), kernel "
            f"{1e3 * kernel_s / launches:.4f} ms ({len(recs)} records, "
            f"{launches} launches, fused {share(FUSED)}, streamed "
            f"{share(STREAMED)})")
    return 100.0 * bound / kernel_s
