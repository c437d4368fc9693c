"""Host utilities of the port: checkpoint files, step timers, traces."""
from node2vec_torch.utils.checkpoint import (
    load_train_state,
    load_walk_chunks,
    save_train_state,
    save_walk_chunk,
)
from node2vec_torch.utils.metrics import StepTimer, profiler_trace

__all__ = [
    "save_walk_chunk",
    "load_walk_chunks",
    "save_train_state",
    "load_train_state",
    "StepTimer",
    "profiler_trace",
]
