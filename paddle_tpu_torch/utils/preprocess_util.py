"""Dataset preprocessing helpers
(ref: python/paddle/utils/preprocess_util.py — file listing, label sets,
grouped shuffling). The generic pieces are implemented for real; the
paddle-v1 binary "batch" pickling (create_batches) belongs to the
retired v1 trainer format and raises with the modern path.
"""
import os
import pickle
import random

__all__ = [
    "save_file", "save_list", "exclude_pattern", "list_dirs",
    "list_images", "list_files", "get_label_set_from_dir", "Label",
    "Dataset", "DataBatcher", "DatasetCreater",
]


def save_file(data, filename):
    """Pickle ``data`` to ``filename`` (ref preprocess_util.py:22)."""
    with open(filename, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


def save_list(l, outfile):
    """Write one entry per line (ref :31)."""
    with open(outfile, "w") as f:
        for item in l:
            f.write(str(item) + "\n")


def exclude_pattern(f):
    """Hidden/underscore names are excluded (ref :40)."""
    return f.startswith(".") or f.startswith("_")


def list_dirs(path):
    """Immediate subdirectories, pattern-filtered (ref :48)."""
    return sorted(
        d for d in os.listdir(path)
        if os.path.isdir(os.path.join(path, d)) and not exclude_pattern(d)
    )


def list_images(path, exts=frozenset(("jpg", "png", "bmp", "jpeg"))):
    """Image files under ``path`` (ref :60)."""
    return sorted(
        f for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f))
        and not exclude_pattern(f)
        and f.rsplit(".", 1)[-1].lower() in exts
    )


def list_files(path):
    """All regular files under ``path`` (ref :71)."""
    return sorted(
        f for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f)) and not exclude_pattern(f)
    )


def get_label_set_from_dir(path):
    """label name -> id from subdirectory names (ref :81)."""
    return {name: i for i, name in enumerate(list_dirs(path))}


class Label(object):
    """ref :97."""

    def __init__(self, label, name):
        self.label = label
        self.name = name

    def __hash__(self):
        return hash(self.label)

    def __eq__(self, other):
        return isinstance(other, Label) and self.label == other.label

    def convert_to_paddle_format(self):
        return int(self.label)


class Dataset(object):
    """Grouped, shuffle-able sample collection (ref :123). ``data`` is a
    list of tuples, ``keys`` names each tuple slot."""

    def __init__(self, data, keys):
        self.data = list(data)
        self.keys = list(keys)

    def check_valid(self):
        for d in self.data:
            if len(d) != len(self.keys):
                return False
        return True

    def uniform_permute(self):
        random.shuffle(self.data)

    def permute_by_key(self, key_id, num_per_batch):
        """Shuffle groups that share data[key_id], then shuffle at batch
        granularity so each ``num_per_batch`` chunk mixes groups
        (ref :155's two-level permute)."""
        groups = {}
        for d in self.data:
            groups.setdefault(d[key_id], []).append(d)
        keys = list(groups)
        random.shuffle(keys)
        flat = [d for k in keys for d in groups[k]]
        if num_per_batch:
            chunks = [flat[i:i + num_per_batch]
                      for i in range(0, len(flat), num_per_batch)]
            random.shuffle(chunks)
            flat = [d for c in chunks for d in c]
        self.data = flat

    permute = permute_by_key


class DataBatcher(object):
    """ref :199 — emits paddle-v1 binary batch files; retired format."""

    def __init__(self, train_data, test_data, label_set):
        self.train_data = train_data
        self.test_data = test_data
        self.label_set = label_set

    def create_batches_and_list(self, *args, **kwargs):
        raise NotImplementedError(
            "DataBatcher writes the retired paddle-v1 binary batch "
            "format; feed samples through fluid.dataset "
            "(InMemoryDataset MultiSlot shards) or a DataLoader "
            "generator instead"
        )

    create_batches = create_batches_and_list


class DatasetCreater(object):
    """ref :264 — directory-walking batch creator; same retired format."""

    def __init__(self, data_path):
        self.data_path = data_path
        self.train_dir_name = "train"
        self.test_dir_name = "test"
        self.batch_dir_name = "batches"

    def create_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "DatasetCreater targets the retired paddle-v1 batch format; "
            "use fluid.dataset / DataLoader pipelines instead"
        )
