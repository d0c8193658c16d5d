"""Image transform utilities (ref: python/paddle/dataset/image.py).

Pure-numpy implementations (the reference shells out to cv2; this
environment has no cv2 and the transforms are trivial array ops). Images
are HWC uint8/float arrays unless stated otherwise.
"""
import numpy as np

__all__ = [
    "load_image_bytes", "load_image", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar",
]


def load_image_bytes(data, is_color=True):
    """Decode raw image bytes. Supports the uncompressed .npy byte form
    this zero-egress environment uses (cv2.imdecode in the reference)."""
    import io

    arr = np.load(io.BytesIO(data), allow_pickle=False)
    return _color(arr, is_color)


def load_image(file, is_color=True):
    arr = np.load(file, allow_pickle=False)
    return _color(arr, is_color)


def _color(im, is_color):
    if is_color and im.ndim == 2:
        im = np.stack([im] * 3, axis=-1)
    if not is_color and im.ndim == 3:
        im = im.mean(axis=-1)
    return im


def _resize_bilinear(im, oh, ow):
    h, w = im.shape[:2]
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    if im.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = im[y0][:, x0].astype(np.float64)
    b = im[y0][:, x1].astype(np.float64)
    c = im[y1][:, x0].astype(np.float64)
    d = im[y1][:, x1].astype(np.float64)
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
           + c * wy * (1 - wx) + d * wy * wx)
    return out.astype(im.dtype)


def resize_short(im, size):
    """Resize so the SHORTER edge equals `size`, keeping aspect ratio."""
    h, w = im.shape[:2]
    if h < w:
        oh, ow = size, int(round(w * size / h))
    else:
        oh, ow = int(round(h * size / w)), size
    return _resize_bilinear(im, oh, ow)


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def _check_crop(im, size):
    h, w = im.shape[:2]
    if size > h or size > w:
        raise ValueError(
            "crop size %d exceeds image dims (%d, %d) — resize first"
            % (size, h, w)
        )


def center_crop(im, size, is_color=True):
    _check_crop(im, size)
    h, w = im.shape[:2]
    y0 = max((h - size) // 2, 0)
    x0 = max((w - size) // 2, 0)
    return im[y0:y0 + size, x0:x0 + size]


def random_crop(im, size, is_color=True):
    _check_crop(im, size)
    h, w = im.shape[:2]
    y0 = np.random.randint(0, max(h - size, 0) + 1)
    x0 = np.random.randint(0, max(w - size, 0) + 1)
    return im[y0:y0 + size, x0:x0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None):
    """resize_short -> crop (random+flip when training, center otherwise)
    -> CHW float32 -> optional mean subtraction (ref image.py:327)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.asarray(mean, "float32")
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(
        load_image(filename, is_color), resize_size, crop_size, is_train,
        is_color, mean,
    )


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    raise NotImplementedError(
        "batch_images_from_tar: tar ingestion is host tooling outside this "
        "zero-egress image; stage .npy arrays and use load_image instead"
    )
