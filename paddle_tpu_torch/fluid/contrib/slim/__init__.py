"""fluid.contrib.slim — model compression (ref: contrib/slim).

Port of paddle_tpu/fluid/contrib/slim:
- prune: masked (lazy) structure pruning of scope params — real sparsity,
  the same shapes; strategies re-assert the masks after every batch, on
  the card, in place.
- distillation: teacher and student in ONE program (the teacher's output
  stop-gradient), so the distill step is one run of one program.
- quantization: QAT fake-quant with straight-through gradients; freeze
  produces a REAL int8 program (int8 products summed in int32);
  PostTrainingQuantization calibrates without retraining (abs-max / KL).
- core: yaml-configured Compressor scheduling strategies per epoch.
- graph: GraphWrapper views over the symbolic Program.
- searcher: SAController (simulated annealing).
- nas: the LightNAS search subsystem — socket ControllerServer +
  SearchAgent protocol and LightNASStrategy driving the SAController
  through the Compressor epoch loop.
"""
from . import core  # noqa: F401
from .core import Compressor, ConfigFactory, Context, Strategy  # noqa: F401
from . import graph  # noqa: F401
from .graph import GraphWrapper  # noqa: F401
from . import prune  # noqa: F401
from . import distillation  # noqa: F401
from . import quantization  # noqa: F401
from . import searcher  # noqa: F401
from . import nas  # noqa: F401
