from .loader import ValLoader, get_val_loader
from .synthetic import Synthetic

__all__ = ['ValLoader', 'get_val_loader', 'Synthetic']
