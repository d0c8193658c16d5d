"""Model builders ported so far."""
from . import bert  # noqa: F401
from . import gpt  # noqa: F401
from . import mnist  # noqa: F401
from . import resnet  # noqa: F401
