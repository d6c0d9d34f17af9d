from .step import build_eval_step, build_predict_step
from .trainer import SegTrainer

__all__ = ['build_eval_step', 'build_predict_step', 'SegTrainer']
