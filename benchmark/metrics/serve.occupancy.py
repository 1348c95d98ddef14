"""serve.occupancy: the server's useful candidate evaluations over all it
made in the window (ServerStats.useful_evals / total_evals). An idle slot
keeps evolving its last target, and that work counts only in the total."""


def read(ctx):
    c = ctx["counters"]
    total = c.get("total_evals", 0)
    return c["useful_evals"] / total if total else None
