#!/usr/bin/env python
"""Reference-compatible entry point of the PyTorch/CUDA port (reference run.py
CLI), on the GPU unless `--device cpu`:

    python run_torch.py --config StyleGAN2_ffhq_d --target "the face of a man with brown eyes"
"""

from clip_glass_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
