"""Training substrate: AdamW, step factories, gradient compression."""
from repro_torch.train.compress import (compressed_psum, ef_compress, ef_init,
                                        quantize_leaf, dequantize_leaf)
from repro_torch.train.optim import (OptConfig, adamw_update, cosine_lr,
                                     init_opt_state, opt_shapes)
from repro_torch.train.step import (StepBundle, make_opt_state,
                                    make_prefill_step, make_serve_step,
                                    make_train_step, opt_state_shapes)

__all__ = [
    "OptConfig", "adamw_update", "cosine_lr", "init_opt_state", "opt_shapes",
    "StepBundle", "make_opt_state", "make_prefill_step", "make_serve_step",
    "make_train_step", "opt_state_shapes", "compressed_psum", "ef_compress",
    "ef_init", "quantize_leaf", "dequantize_leaf",
]
