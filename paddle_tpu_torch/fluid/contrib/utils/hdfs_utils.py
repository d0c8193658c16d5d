"""HDFS client utilities (ref: contrib/utils/hdfs_utils.py).

This environment has no Hadoop runtime: the client keeps the reference
constructor surface but every filesystem call raises with guidance
(stage data to local disk / a FUSE mount and use plain paths — the
dataset trainer path reads local files). Port of
paddle_tpu/fluid/contrib/utils/hdfs_utils.py.
"""
__all__ = ["HDFSClient", "multi_download", "multi_upload"]

_GUIDE = (
    "no Hadoop runtime in this environment; stage files to local disk "
    "(or a FUSE mount) and point set_filelist/readers at local paths"
)


class HDFSClient:
    def __init__(self, hadoop_home, configs):
        self.pre_commands = []
        self.hadoop_home = hadoop_home
        self.configs = configs

    def __getattr__(self, name):
        # ls / is_dir / is_exist / upload / download / delete / rename...
        def _unavailable(*a, **k):
            raise NotImplementedError(
                "HDFSClient.%s: %s" % (name, _GUIDE))

        return _unavailable


def multi_download(client, hdfs_path, local_path, trainer_id, trainers,
                   multi_processes=5):
    raise NotImplementedError("multi_download: " + _GUIDE)


def multi_upload(client, hdfs_path, local_path, multi_processes=5,
                 overwrite=False, sync=True):
    raise NotImplementedError("multi_upload: " + _GUIDE)
