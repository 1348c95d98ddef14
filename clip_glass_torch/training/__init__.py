from clip_glass_torch.training import losses  # noqa: F401
from clip_glass_torch.training.trainer import Trainer, TrainerConfig, TrainState  # noqa: F401
