"""append_backward / gradients.

Port of paddle_tpu/fluid/backward.py (ref python/paddle/fluid/
backward.py). Both append a single symbolic ``backward`` op marking
(loss, targets), so both packages build the same Program. The JAX package
lowers it with jax.vjp over a replay of the preceding region; the port
records that region once with torch.autograd and calls
``torch.autograd.grad`` at the op (fluid/lowering.py run_ops).
"""
from .framework import Variable, grad_var_name

__all__ = ["append_backward", "gradients"]


def _create_grad_var(block, ref_var, name=None):
    name = name or grad_var_name(ref_var.name)
    if block.has_var(name):
        return block.var(name)
    return block.create_var(
        name=name,
        shape=ref_var.shape,
        dtype=ref_var.dtype,
        persistable=False,
        stop_gradient=False,
    )


def append_backward(
    loss, parameter_list=None, no_grad_set=None, callbacks=None,
    checkpoints=None
):
    """Append gradient computation for ``loss`` w.r.t. trainable parameters.

    Returns list of (Parameter, grad Variable) pairs, like the reference.
    """
    assert isinstance(loss, Variable), "loss must be a Variable"
    block = loss.block
    program = block.program
    no_grad = set()
    if no_grad_set:
        no_grad = {
            v.name if isinstance(v, Variable) else v for v in no_grad_set
        }

    if parameter_list is not None:
        params = []
        for p in parameter_list:
            if isinstance(p, str):
                params.append(block._var_recursive(p))
            else:
                params.append(p)
    else:
        params = [
            p
            for p in program.all_parameters()
            if getattr(p, "trainable", True)
        ]
    params = [p for p in params if p.name not in no_grad]
    if not params:
        raise ValueError("no trainable parameters to differentiate")

    target_names = [p.name for p in params]
    grad_vars = [_create_grad_var(block, p) for p in params]
    _create_grad_var(block, loss)

    block.append_op(
        type="backward",
        inputs={"Loss": [loss.name]},
        outputs={"Grads": [g.name for g in grad_vars]},
        attrs={
            "targets": target_names,
            "checkpoints": [
                c.name if isinstance(c, Variable) else c
                for c in (checkpoints or [])
            ],
        },
    )
    program._loss_name = loss.name
    program._appending_grad_times += 1
    return list(zip(params, grad_vars))


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Compute gradients of ``targets`` w.r.t. arbitrary ``inputs`` —
    params, feeds, or intermediate vars (the lowering differentiates with
    respect to the value the producing op left in the run's env). Ref
    backward.py gradients().

    ``target_gradients`` seeds the cotangent (default: ones, the
    reference's fill-1 seed); ``no_grad_set`` vars are treated as
    constants: their value is detached where it is produced.
    """
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if target_gradients is not None:
        if isinstance(target_gradients, Variable):
            target_gradients = [target_gradients]
        assert len(target_gradients) == len(targets), (
            "target_gradients must pair 1:1 with targets"
        )
    assert len(targets) == 1, (
        "gradients() supports a single scalar target; combine targets "
        "with layers.sum first"
    )
    loss = targets[0]
    block = loss.block
    no_grad = sorted(
        {v.name if isinstance(v, Variable) else v for v in (no_grad_set or ())}
    )
    grad_vars = [_create_grad_var(block, v) for v in inputs]
    ins = {"Loss": [loss.name]}
    attrs = {
        "targets": [v.name for v in inputs],
        "checkpoints": [],
        "no_grad": no_grad,
    }
    if target_gradients is not None and target_gradients[0] is not None:
        # a None entry means "seed with ones" (the default), per reference
        ins["InitGrad"] = [target_gradients[0].name]
    block.append_op(
        type="backward",
        inputs=ins,
        outputs={"Grads": [g.name for g in grad_vars]},
        attrs=attrs,
    )
    return grad_vars
