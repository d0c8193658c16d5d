"""Convert lua-torch .t7 model files (ref: python/paddle/utils/
torch2paddle.py — torchfile-based weight import into the v1 parameter
format).

Both ends of that pipeline are retired (lua-torch sources, paddle-v1
parameter files). For PyTorch interop, load the state_dict with torch
(installed in this image) and assign arrays into the scope::

    sd = torch.load("model.pt", map_location="cpu")
    for name, tensor in sd.items():
        fluid.global_scope().update(mapped_name(name), tensor.numpy())

The legacy entry points below raise with this guidance.
"""
__all__ = ["main"]

_MSG = (
    "torch2paddle converted lua-torch .t7 files into retired paddle-v1 "
    "parameter files; neither format exists here. For PyTorch weights, "
    "torch.load the state_dict and write arrays into "
    "fluid.global_scope() (see module docstring)."
)


def t7_to_paddle(*args, **kwargs):
    raise NotImplementedError(_MSG)


def main(*args, **kwargs):
    raise NotImplementedError(_MSG)
