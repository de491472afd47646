from . import distributions, loader
from .loader import Batch, LoaderState, SyntheticLoader
