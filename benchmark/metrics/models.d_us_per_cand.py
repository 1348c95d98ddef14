"""models.d_us_per_cand: CUDA events around every call of the discriminator
(StyleGAN2's discriminator_apply) in the traced window: their device time
over the rows they scored, in us a candidate."""


def read(ctx):
    seconds, rows = ctx["spans"].get("models.D", (0.0, 0))
    return 1e6 * seconds / rows if rows else None
