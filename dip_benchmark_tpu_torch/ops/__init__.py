"""Op registry: the 12 on-device ops of the uint8 matrix, keyed by CSV column.

``OPS`` maps each column to a function of the planar padded
``(C, Hp, pitch)`` tensor that returns a tensor of the same layout. The
kernels read their geometry from the tensor, so unlike the JAX package's
``build_ops(layout)`` nothing is built per layout, and since every op maps
the layout to itself, ``utils.image.from_planar_padded`` crops any output
to the uint8 HWC image the harness dumps and verifies.
"""

from __future__ import annotations

from dip_benchmark_tpu import spec

from . import point, window

# CSV column -> (wrapper, its plain PyTorch version, the op's arguments
# after the planar tensor). OPS and PLAIN are both built from this one
# table, so a kernel and its plain version always get the same masks and
# shifts.
TABLE = {
    "Copy": (point.copy, point.copy_plain, ()),
    "Inversion": (point.inversion, point.inversion_plain, ()),
    "Grayscale": (point.grayscale, point.grayscale_plain, ()),
    "Threshold": (point.threshold, point.threshold_plain, ()),
    "Erosion-3x3-Cross": (window.erosion, window.erosion_plain,
                          (spec.CROSS_MASK_3X3,)),
    "Erosion-3x3-Square": (window.erosion, window.erosion_plain,
                           (spec.SQUARE_MASK_3X3,)),
    "Erosion-1x3+3x1-Square": (window.erosion_separated,
                               window.erosion_sep_plain, ()),
    "Convolution-3x3": (window.convolution, window.conv_dense_plain,
                        (spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT)),
    "Convolution-1x3+3x1": (window.convolution_separated,
                            window.conv_sep_plain,
                            (spec.BLUR_1X3_INT, spec.BLUR_3X1_INT,
                             spec.BLUR_SEP3_SHIFT)),
    "Convolution-5x5": (window.convolution, window.conv_dense_plain,
                        (spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT)),
    "Convolution-1x5+5x1": (window.convolution_separated,
                            window.conv_sep_plain,
                            (spec.BLUR_1X5_INT, spec.BLUR_5X1_INT,
                             spec.BLUR_SEP5_SHIFT)),
    "Gaussian-Blur-3x3": (window.gaussian_blur_3x3, window.blur3x3_plain, ()),
}


def _bind(fn, args):
    return lambda planar: fn(planar, *args)


# The wrappers: the CUDA kernel for a tensor on the card, the plain version
# for a CPU tensor.
OPS = {col: _bind(wrapper, args) for col, (wrapper, _, args) in TABLE.items()}
# The plain PyTorch version of each op, on any device: what the kernels are
# held against on the card.
PLAIN = {col: _bind(plain, args) for col, (_, plain, args) in TABLE.items()}
