from .base import SegConfig, refuse_unported
from .parser import get_parser, load_parser

__all__ = ['SegConfig', 'get_parser', 'load_parser', 'refuse_unported']
