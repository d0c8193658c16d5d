"""Image dataset preprocessing (ref: python/paddle/utils/
preprocess_img.py — PIL resize + the v1 batch creator).

``resize_image`` (the generally useful piece) is real; the batch
creators target the retired paddle-v1 binary format and raise with the
modern pipeline (see preprocess_util.DataBatcher).
"""
import os

import numpy as np

from . import preprocess_util
from .image_util import crop_img

__all__ = ["resize_image", "DiskImage", "ImageClassificationDatasetCreater"]


def resize_image(img, target_size):
    """Shorter-edge resize to ``target_size`` keeping aspect ratio
    (ref preprocess_img.py:25)."""
    from PIL import Image

    percent = target_size / float(min(img.size[0], img.size[1]))
    resized_size = (int(round(img.size[0] * percent)),
                    int(round(img.size[1] * percent)))
    return img.resize(resized_size, Image.LANCZOS)


class DiskImage(object):
    """An image on disk, lazily loaded + resized (ref :43)."""

    def __init__(self, path, target_size):
        self.path = path
        self.target_size = target_size
        self.img = None

    def read_image(self):
        if self.img is None:
            from PIL import Image

            img = Image.open(self.path)
            if img.mode != "RGB":
                img = img.convert("RGB")
            self.img = resize_image(img, self.target_size)

    def convert_to_array(self):
        self.read_image()
        np_array = np.array(self.img)
        if len(np_array.shape) == 3:
            np_array = np.swapaxes(np_array, 1, 2)
            np_array = np.swapaxes(np_array, 0, 1)
        return np_array

    def convert_to_paddle_format(self):
        """CHW uint8 bytes, center-cropped square (ref :67)."""
        self.read_image()
        return crop_img(
            np.asarray(self.img), self.target_size, test=True
        ).tobytes()


class ImageClassificationDatasetCreater(preprocess_util.DatasetCreater):
    """ref :83 — walks label dirs and writes v1 batches; the walker is
    real (uses preprocess_util listings), the batch write raises."""

    def __init__(self, data_path, target_size, color=True):
        super().__init__(data_path)
        self.target_size = target_size
        self.color = color

    def create_dataset_from_dir(self, path):
        labels = preprocess_util.get_label_set_from_dir(path)
        data = []
        for name, label in labels.items():
            for img in preprocess_util.list_images(
                    os.path.join(path, name)):
                data.append((DiskImage(os.path.join(path, name, img),
                                       self.target_size),
                             preprocess_util.Label(label, name)))
        return preprocess_util.Dataset(data, ["image", "label"])

    create_dataset_from_list = preprocess_util.DatasetCreater.create_dataset
