"""Model builders ported so far."""
from . import bert  # noqa: F401
