"""slim.searcher (ref: contrib/slim/searcher)."""
from . import controller  # noqa: F401
from .controller import EvolutionaryController, SAController  # noqa: F401

__all__ = ["EvolutionaryController", "SAController"]
