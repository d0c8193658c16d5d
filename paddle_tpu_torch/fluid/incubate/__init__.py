"""fluid.incubate (ref: python/paddle/fluid/incubate): the data generators
of the Dataset trainer path. The fleet API comes with the parallel slice
(ROADMAP.md Queue 1, item 8)."""
from . import data_generator  # noqa: F401
