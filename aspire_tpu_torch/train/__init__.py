from .schedules import build_schedule
from .trainer import Trainer, TrainState
