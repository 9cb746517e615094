"""search.enqueue_ms: the host's time to enqueue one batch's ``search``
(host clock around each call, no synchronize), as a mean over the
window's batches, in ms. Where it exceeds the device's time a batch, the
host sets the rate."""

import statistics


def read(ctx):
    spans = ctx.spans.get("search")
    return 1e3 * statistics.fmean(spans) if spans else None
