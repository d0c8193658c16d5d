"""fp16 master-weight helpers (ref contrib/mixed_precision/
fp16_utils.py); port of paddle_tpu's.

The reference keeps fp16 train params + fp32 master copies and casts
between them around each update. This framework's AMP keeps parameters
fp32 always and casts op inputs to bfloat16 (see the package
docstring), so master copies exist by construction:

- ``create_master_params_grads`` returns the (param, grad) pairs
  unchanged — they already are the fp32 masters.
- ``master_param_to_train_param`` is a no-op — there is no separate
  fp16 weight tensor to copy back into.
- ``update_loss_scaling`` is built into the program
  (OptimizerWithMixedPrecision wires it); calling it standalone raises
  with that pointer.
"""

__all__ = ["create_master_params_grads", "master_param_to_train_param",
           "update_loss_scaling"]


def create_master_params_grads(params_grads, main_prog, startup_prog,
                               loss_scaling):
    """Identity under fp32-resident params (see module docstring)."""
    return list(params_grads)


def master_param_to_train_param(all_params_grads, params_grads,
                                main_prog):
    """No separate train-dtype weights exist; nothing to copy."""


def update_loss_scaling(is_overall_finite=None, prev_loss_scaling=None,
                        num_good_steps=None, num_bad_steps=None,
                        incr_every_n_steps=None,
                        decr_every_n_nan_or_inf=None, incr_ratio=None,
                        decr_ratio=None):
    raise NotImplementedError(
        "update_loss_scaling is built into the training program by "
        "mixed_precision.decorate(..., use_dynamic_loss_scaling=True); "
        "it is not a standalone op here"
    )
