from .state import TrainState, ema_update
from .step import build_eval_step, build_predict_step, build_train_step
from .trainer import SegTrainer

__all__ = ['TrainState', 'ema_update', 'build_eval_step',
           'build_predict_step', 'build_train_step', 'SegTrainer']
