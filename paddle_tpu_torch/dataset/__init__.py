"""Canned datasets (ref: python/paddle/dataset/). Zero-egress environment:
each dataset synthesizes a deterministic stand-in with the real schema/shape
unless local files are provided via env vars."""
from . import common  # noqa: F401
from . import mnist  # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb  # noqa: F401
from . import cifar  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import wmt16  # noqa: F401
from . import wmt14  # noqa: F401
from . import voc2012  # noqa: F401
from . import mq2007  # noqa: F401
from . import image  # noqa: F401
from . import sentiment  # noqa: F401
from . import conll05  # noqa: F401
from . import flowers  # noqa: F401
