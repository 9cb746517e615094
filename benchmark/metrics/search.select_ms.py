"""search.select_ms: the search's selection stage a batch, in ms: the mean
over a pass of the traced batches with the program's spans on of the time
between the CUDA events of its ``search.select`` span (the per-task and
global top-R over the rough distances and the slot decode), the card's
idle time inside the stage included (benchmark/stages.py).

Beside it, the pass's device-idle time is logged by the program's span
that holds each idle gap's midpoint."""

from benchmark import stages


def read(ctx):
    value = stages.read_stage(ctx, "search.select")
    p = stages.stage_pass(ctx)
    split = None if p is None else stages.idle_by_span(p.view, p.spans)
    if split is not None:
        idle, err = split
        n = len(p.batches)
        ctx.log("[search.select_ms] device idle by span, ms a batch: "
                + ", ".join(f"{k} {1e3 * v / n:.4f}" for k, v in idle.items())
                + f"; alignment error <= {err:.1f} us")
    return value
