from clip_glass_torch.tokenizers.clip_bpe import (  # noqa: F401
    CLIPTokenizer,
    get_clip_tokenizer,
    tokenize,
)
