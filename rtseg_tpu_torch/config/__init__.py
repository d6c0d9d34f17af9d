from .base import SegConfig

__all__ = ['SegConfig']
