"""Generative-model metrics: FID (with the FID InceptionV3), PPL and the
LPIPS-VGG16 distance."""

from clip_glass_torch.metrics.fid import FID, frechet_distance  # noqa: F401
from clip_glass_torch.metrics.ppl import PPL  # noqa: F401
