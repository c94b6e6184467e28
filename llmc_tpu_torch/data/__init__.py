from . import preproc  # noqa: F401  (registers PREPROC_REGISTRY entries)
from .dataset import CalibDataset

__all__ = ['CalibDataset']
