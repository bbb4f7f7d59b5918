"""Training (port of ``repro.train``): AdamW, the train and serve steps, the
checkpoint format both frameworks read, the ordered data pipeline and int8
gradient compression.  Importing it does not touch CUDA."""
from .checkpoint import CheckpointManager
from .data import DataConfig, OrderedTokenPipeline
from .grad_compression import compress_allreduce_leaf, init_error_state, make_compressed_allreduce
from .optimizer import OptConfig, apply_adamw, global_norm, init_opt_state, schedule
from .train_step import make_prefill_step, make_serve_step, make_train_step

__all__ = [
    "CheckpointManager", "DataConfig", "OptConfig", "OrderedTokenPipeline", "apply_adamw",
    "compress_allreduce_leaf", "global_norm", "init_error_state", "init_opt_state",
    "make_compressed_allreduce", "make_prefill_step", "make_serve_step", "make_train_step",
    "schedule",
]
