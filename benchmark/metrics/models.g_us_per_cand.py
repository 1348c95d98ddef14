"""models.g_us_per_cand: CUDA events around every call of the generator in
the traced window: their device time over the rows they scored, in us a
candidate. The generator is StyleGAN2's generator_apply, BigGAN's apply
(harness/trace.py), and GPT-2's sample_sequence, the whole argmax decode of
a chunk of contexts, prefill and every step, as the host issues it
(families/gpt2.py)."""


def read(ctx):
    seconds, rows = ctx["spans"].get("models.G", (0.0, 0))
    return 1e6 * seconds / rows if rows else None
