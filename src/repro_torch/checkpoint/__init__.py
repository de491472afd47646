from . import checkpointer
from .manager import CheckpointManager
