"""contrib.utils (ref: contrib/utils): HDFS + distributed lookup-table
maintenance utilities."""
from . import hdfs_utils  # noqa: F401
from . import lookup_table_utils  # noqa: F401
from .hdfs_utils import HDFSClient, multi_download, multi_upload  # noqa: F401

__all__ = list(hdfs_utils.__all__) + list(lookup_table_utils.__all__)
