"""Training (port of ``repro.train``): AdamW, the train and serve steps, the
checkpoint format both frameworks read, the ordered data pipeline and int8
gradient compression.  Importing it does not touch CUDA."""
from .checkpoint import CheckpointManager
from .data import DataConfig, OrderedTokenPipeline
from .grad_compression import (compress_allreduce_leaf, init_error_state,
                               make_compressed_allreduce, make_compressed_psum)
from .optimizer import (OptConfig, abstract_opt_state, apply_adamw, global_norm, init_opt_state,
                        opt_state_pspecs, schedule)
from .train_step import (abstract_prefill_batch, abstract_serve_inputs, abstract_train_batch,
                         make_prefill_step, make_serve_step, make_train_step, prefill_shardings,
                         serve_shardings, train_step_shardings)

__all__ = [
    "CheckpointManager", "DataConfig", "OptConfig", "OrderedTokenPipeline",
    "abstract_opt_state", "abstract_prefill_batch", "abstract_serve_inputs",
    "abstract_train_batch", "apply_adamw", "compress_allreduce_leaf", "global_norm",
    "init_error_state", "init_opt_state", "make_compressed_allreduce", "make_compressed_psum",
    "make_prefill_step", "make_serve_step", "make_train_step", "opt_state_pspecs",
    "prefill_shardings", "schedule", "serve_shardings", "train_step_shardings",
]
