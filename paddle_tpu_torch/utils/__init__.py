"""paddle.utils (ref: python/paddle/utils): Ploter (training-curve
logging), image_util (numpy image preprocessing), plus the legacy
preprocessing/conversion modules (real where the behavior survives,
loud raises where they target retired v1 formats — see each module)."""
from . import plot  # noqa: F401
from . import image_util  # noqa: F401
from . import plotcurve  # noqa: F401
from . import preprocess_util  # noqa: F401
from . import preprocess_img  # noqa: F401
from . import show_pb  # noqa: F401
from . import torch2paddle  # noqa: F401
from .plot import Ploter, PlotData  # noqa: F401

__all__ = ["plot", "image_util", "Ploter", "PlotData", "plotcurve",
           "preprocess_util", "preprocess_img", "show_pb",
           "torch2paddle"]
