from .pruner import Pruner, StructurePruner, prune_program  # noqa: F401
from . import prune_strategy  # noqa: F401
from .prune_strategy import (  # noqa: F401
    PruneStrategy,
    SensitivePruneStrategy,
    UniformPruneStrategy,
)

__all__ = [
    "Pruner", "StructurePruner", "prune_program", "PruneStrategy",
    "UniformPruneStrategy", "SensitivePruneStrategy",
]
