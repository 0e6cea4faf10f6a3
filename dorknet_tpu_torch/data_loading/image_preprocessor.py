"""Host-side preprocessing of packed canvases (counterpart of
``dorknet_tpu/data_loading/image_preprocessor.py``), the crop modes only.

A packed canvas is already resized to the 1.25x precrop, so a random or
center crop to ``image_size`` and the BGR HWC uint8 -> CHW float32 layout
with the -128 mean shift are all a batch needs, and they are bit-equal to
the JAX package's. Resizing (a loader without a crop mode, or decoding a
JPEG) and the host augmenter need cv2, which the port does not use: they
raise ``NotImplementedError`` (ROADMAP A5).
"""

import numpy as np

_NEEDS_CV2 = "needs cv2, which the port does not use yet (ROADMAP A5)"


def default_precrop(image_size):
    """The reference's 1.25x pre-crop canvas for a given output size."""
    return (int(image_size[0] * 1.25), int(image_size[1] * 1.25))


def crop_origin(canvas_shape, out_size, mode):
    """Top-left (row, col) of the crop window on a canvas.

    ``random`` draws from np.random (excluding the bottom/right-flush
    positions, as the reference's exclusive randint bounds do); ``center``
    floors the midpoint. ``out_size`` indexes as the reference does:
    element 0 against rows, element 1 against cols."""
    if mode == "random":
        return (np.random.randint(0, canvas_shape[0] - out_size[0]),
                np.random.randint(0, canvas_shape[1] - out_size[1]))
    return ((canvas_shape[0] - out_size[0]) // 2,
            (canvas_shape[1] - out_size[1]) // 2)


def to_network_layout(im):
    """HWC BGR (uint8) -> CHW float32 with the -128 mean shift, the input
    every model of the framework trains on."""
    return im.transpose(2, 0, 1).astype(np.float32) - 128.0


def preprocess_canvas(im, image_size, crop_mode=None, augmenter=None,
                      apply_augmenter=True):
    """One packed canvas (HWC uint8 at the precrop size) -> the network's
    CHW float32 input, cropped to ``image_size`` by ``crop_mode`` ("random"
    or "center"). ``apply_augmenter`` is kept for the JAX package's
    signature; an augmenter raises."""
    if crop_mode not in ("random", "center"):
        raise NotImplementedError(
            "preprocess_canvas without a crop mode resizes the canvas, which " + _NEEDS_CV2)
    if augmenter is not None:
        raise NotImplementedError("the host augmenter " + _NEEDS_CV2)
    r, c = crop_origin(im.shape, image_size, crop_mode)
    return to_network_layout(im[r:r + image_size[0], c:c + image_size[1], :])


class ImagePreprocessor:
    """Configured preprocessing; the loader reads ``precrop_size``,
    ``image_size`` and ``crop_mode``. ``apply_augmenter`` is kept for the
    JAX package's signature. There is no ``load_image``: decoding a file
    needs cv2 (ROADMAP A5)."""

    def __init__(self, image_size, crop_mode=None, precrop_size=None,
                 image_augmenter=None, apply_augmenter=True):
        if image_augmenter is not None:
            raise NotImplementedError("ImagePreprocessor(image_augmenter=...): the host "
                                      "augmenter " + _NEEDS_CV2)
        self.image_size = image_size  # (width, height)
        self.crop_mode = crop_mode
        self.precrop_size = precrop_size or default_precrop(image_size)
