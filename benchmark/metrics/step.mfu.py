"""step.mfu: the frozen model FLOPs a candidate (yardstick/flops.py) times
the traced window's candidates a second, over the card's dense bf16 peak
(yardstick/peaks.py), in %."""


def read(ctx):
    if not ctx["peak"]:
        return None
    return 100.0 * ctx["fpc"] * ctx["rate"] / ctx["peak"]
