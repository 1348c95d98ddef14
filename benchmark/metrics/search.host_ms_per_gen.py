"""search.host_ms_per_gen: a generation's wall time minus its evaluation
call's, each fenced by a synchronize, averaged over the traced window's
generations, in ms: selection, variation, duplicate resampling and
survival, with the host's share of their launches."""


def read(ctx):
    gens = ctx["gens"]
    if not gens:
        return None
    return 1e3 * sum(step - evaluation for step, evaluation in gens) / len(gens)
