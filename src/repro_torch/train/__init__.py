from .loop import StragglerDetector, Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "StragglerDetector"]
