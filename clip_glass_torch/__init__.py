"""clip_glass_torch: CLIP-guided generative latent-space search in PyTorch.

The PyTorch/CUDA counterpart of the JAX package `clip_glass_tpu`, laid out
module for module like it. The StyleGAN2 text-to-image NSGA-II search runs
end to end; its hot elementwise/stencil passes are hand-written CUDA kernels
for Hopper (`csrc/`), each beside a plain PyTorch version of the same
function that serves CPU tensors.

Entry points (`fitness.problem.GenerationProblem`, `fitness.generator.
Generator`, `evolve.algorithm.minimize`) run on the GPU unless the caller
passes `device="cpu"`; without a GPU they raise instead of falling back.
"""

from clip_glass_torch.config import Config, get_config, list_configs  # noqa: F401

__version__ = "0.1.0"
