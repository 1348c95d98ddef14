from clip_glass_torch.tokenizers.gpt2_bpe import GPT2Tokenizer, get_gpt2_tokenizer  # noqa: F401
from clip_glass_torch.tokenizers.clip_bpe import (  # noqa: F401
    CLIPTokenizer,
    get_clip_tokenizer,
    tokenize,
)
