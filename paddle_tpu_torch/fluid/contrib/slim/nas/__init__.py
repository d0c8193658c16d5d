"""slim.nas (ref: contrib/slim/nas) — the LightNAS search subsystem.

Port of paddle_tpu/fluid/contrib/slim/nas: the socket ControllerServer +
SearchAgent protocol and the LightNASStrategy search loop (host-side TCP
with nothing pserver-specific), driving the SAController in
slim.searcher and evaluating candidates through the port's Executor.
"""
from .controller_server import ControllerServer
from .light_nas_strategy import LightNASStrategy
from .lock import lock, unlock
from .search_agent import SearchAgent
from .search_space import SearchSpace

# the older spelling kept importable (yaml configs in the wild)
LightNasStrategy = LightNASStrategy

__all__ = [
    "ControllerServer", "LightNASStrategy", "LightNasStrategy",
    "SearchAgent", "SearchSpace", "lock", "unlock",
]
