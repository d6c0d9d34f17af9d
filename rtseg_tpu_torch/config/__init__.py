from .base import SegConfig, refuse_unported

__all__ = ['SegConfig', 'refuse_unported']
