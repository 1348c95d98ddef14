"""setup.stage_s: the seconds the port spent staging its weights, over the
process: the total of its `setup.stage` spans (`Generator.__init__`: the
weights read or handed in, precast to the compute dtype and moved to the
card, and the int8 calibration where there is one; read from
`clip_glass_torch.core.profiling.TRACER`, whose totals outlast its ring).
None where the port records no such span."""


def read(ctx):
    try:
        from clip_glass_torch.core.profiling import TRACER
    except ImportError:
        return None
    total = TRACER.totals().get("setup.stage")
    return total.ns / 1e9 if total else None
