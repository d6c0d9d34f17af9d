from .base import SegConfig, not_ported, refuse_unported
from .parser import get_parser, load_parser

__all__ = ['SegConfig', 'get_parser', 'load_parser', 'not_ported',
           'refuse_unported']
