"""fitness.eval_us_per_cand: CUDA events around every call of the evaluation
(the algorithm's evaluation function, or the server's batched evaluation) in
the traced window: their device time over the rows they scored, in us a
candidate."""


def read(ctx):
    seconds, rows = ctx["spans"].get("fitness.eval", (0.0, 0))
    return 1e6 * seconds / rows if rows else None
