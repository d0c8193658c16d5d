"""Numpy image preprocessing helpers (behavioral parity target:
python/paddle/utils/image_util.py) — short-side resize, flips, padded
center/random crops, 10-crop oversampling, and the channel/mean
transformer used by the classic image pipelines.

Written as vectorized numpy over an (N, H, W, C) batch axis where the
operation allows it; single images are the N=1 case.
"""
import numpy as np

__all__ = [
    "resize_image", "flip", "crop_img", "preprocess_img", "load_image",
    "oversample", "ImageTransformer",
]


def resize_image(img, target_size):
    """Scale a PIL image so its SHORT side equals target_size, keeping
    aspect ratio."""
    w, h = img.size
    scale = target_size / min(w, h)
    return img.resize((round(w * scale), round(h * scale)))


def flip(im):
    """Mirror the width axis of a (C, H, W) or (H, W) array."""
    return np.flip(im, axis=-1)


def _pad_to_square_min(im, size, spatial_axes):
    """Zero-pad so every spatial axis is at least `size`."""
    pads = [(0, 0)] * im.ndim
    for ax in spatial_axes:
        short = max(size - im.shape[ax], 0)
        pads[ax] = (short // 2, short - short // 2)
    if any(p != (0, 0) for p in pads):
        im = np.pad(im, pads)
    return im


def crop_img(im, inner_size, color=True, test=True):
    """Crop to inner_size x inner_size: centered when `test`, else a
    uniformly random window plus a coin-flip mirror. Images smaller than
    the crop are zero-padded to fit first. Layout: (C, H, W) when color,
    (H, W) otherwise."""
    im = np.asarray(im, dtype="float32")
    spatial = (-2, -1) if color else (0, 1)
    im = _pad_to_square_min(im, inner_size, spatial)
    room_y = im.shape[spatial[0]] - inner_size
    room_x = im.shape[spatial[1]] - inner_size
    if test:
        y0, x0 = room_y // 2, room_x // 2
    else:
        y0 = np.random.randint(room_y + 1)
        x0 = np.random.randint(room_x + 1)
    window = im[..., y0:y0 + inner_size, x0:x0 + inner_size]
    if not test and np.random.randint(2) == 0:
        window = flip(window)
    return window


def preprocess_img(im, img_mean, crop_size, is_train, color=True):
    """Crop (random when training, center otherwise) then subtract the
    pixel mean."""
    return crop_img(im, crop_size, color, test=not is_train) - img_mean


def load_image(img_path, is_color=True):
    """Read an image file into a PIL image (RGB or grayscale)."""
    from PIL import Image

    with Image.open(img_path) as f:
        f.load()
        return f.convert("RGB" if is_color else "L")


def oversample(img, crop_dims):
    """Classic 10-crop TTA: four corners + center, each mirrored.

    img: sequence of (H, W, C) arrays sharing one shape.
    Returns (10 * len(img), ch, cw, C), ordered per image as the five
    crops followed by their mirrors.
    """
    batch = np.stack([np.asarray(i, dtype="float32") for i in img])
    _, H, W, _ = batch.shape
    ch, cw = int(crop_dims[0]), int(crop_dims[1])
    # window origins: corners then center (int floor of the centered box)
    ys = [0, 0, H - ch, H - ch, int(H / 2.0 - ch / 2.0)]
    xs = [0, W - cw, 0, W - cw, int(W / 2.0 - cw / 2.0)]
    views = np.stack(
        [batch[:, y:y + ch, x:x + cw, :] for y, x in zip(ys, xs)], axis=1
    )                                        # (N, 5, ch, cw, C)
    both = np.concatenate([views, views[:, :, :, ::-1, :]], axis=1)
    return both.reshape(-1, ch, cw, batch.shape[-1])


class ImageTransformer:
    """Axis-order / channel-order / mean normalization applied in that
    sequence; mean given per channel is broadcast over H, W."""

    def __init__(self, transpose=None, channel_swap=None, mean=None,
                 is_color=True):
        self.is_color = is_color
        self.set_transpose(transpose)
        self.set_channel_swap(channel_swap)
        self.set_mean(mean)

    def _check3(self, order, what):
        if order is not None and self.is_color and len(order) != 3:
            raise ValueError("%s needs 3 entries for color images" % what)

    def set_transpose(self, order):
        self._check3(order, "transpose order")
        self.transpose = order

    def set_channel_swap(self, order):
        self._check3(order, "channel swap")
        self.channel_swap = order

    def set_mean(self, mean):
        if mean is not None:
            mean = np.asarray(mean)
            if mean.ndim == 1:  # per-channel -> broadcastable (C, 1, 1)
                mean = mean.reshape(-1, 1, 1)
        self.mean = mean

    def transformer(self, data):
        if self.transpose is not None:
            data = np.transpose(data, self.transpose)
        if self.channel_swap is not None:
            data = np.take(data, self.channel_swap, axis=0)
        if self.mean is not None:
            data = data - self.mean
        return data
