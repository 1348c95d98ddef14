"""models.clip_us_per_cand: CUDA events around every call of CLIP's tower in
the traced window: their device time over the rows they scored, in us a
candidate. The tower is the image tower (encode_image, harness/trace.py) for
the image families, and for GPT-2 the text tower on the captions' tokens
(encode_text, families/gpt2.py)."""


def read(ctx):
    seconds, rows = ctx["spans"].get("models.CLIP", (0.0, 0))
    return 1e6 * seconds / rows if rows else None
