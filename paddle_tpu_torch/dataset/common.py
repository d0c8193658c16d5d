"""Dataset plumbing (ref: python/paddle/dataset/common.py). This image
has zero egress, so download() only serves files already staged locally
(PADDLE_TPU_DATA_HOME or ~/.cache/paddle_tpu/dataset) and says so
otherwise; the file utilities are real."""
import glob
import hashlib
import os
import pickle

__all__ = [
    "DATA_HOME", "download", "md5file", "split", "cluster_files_reader",
    "must_mkdirs", "fetch_all",
]

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu",
                 "dataset"),
)


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Resolve an already-staged file (zero-egress environment). The
    canned paddle_tpu_torch.dataset readers synthesize data and never call
    this; it exists for user scripts that stage real corpora."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name or url.split("/")[-1]
    )
    if os.path.exists(filename) and (
        not md5sum or md5file(filename) == md5sum
    ):
        return filename
    raise RuntimeError(
        "download() cannot fetch %r: this environment has no network "
        "egress. Stage the file at %s (PADDLE_TPU_DATA_HOME to "
        "relocate), or use the synthetic paddle_tpu_torch.dataset readers."
        % (url, filename)
    )


def fetch_all():
    """No-op: canned datasets are synthesized on the fly."""


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """Shard a reader's samples into pickle files (ref common.py:128)."""
    indx = 0
    lines = []
    for line in reader():
        lines.append(line)
        if len(lines) >= line_count:
            with open(suffix % indx, "wb") as f:
                dumper(lines, f)
            lines = []
            indx += 1
    if lines:
        with open(suffix % indx, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """Read this trainer's shard of the split files (ref common.py:166)."""

    def reader():
        flist = sorted(glob.glob(files_pattern))
        my_files = [
            f for i, f in enumerate(flist)
            if i % trainer_count == trainer_id
        ]
        for fn in my_files:
            with open(fn, "rb") as f:
                for item in loader(f):
                    yield item

    return reader
