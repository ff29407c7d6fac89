"""Op registry: the 13 on-device ops of each data model, keyed by CSV column.

The 12 ops of the matrix and the fused pipeline ("Fused-Pipeline", the
``--pipeline`` row, which has no CSV column), as the JAX package's
``build_ops`` registers them. ``OPS`` maps each column to a function of
the planar padded ``(C, Hp, pitch)`` tensor that returns a tensor of the
same layout. The kernels read their geometry from the tensor, so unlike
the JAX package's ``build_ops(layout)`` nothing is built per layout, and
since every op maps the layout to itself, ``utils.image.from_planar_padded``
crops any output to the uint8 HWC image the harness dumps and verifies.

``OPS_F32`` and ``PLAIN_F32`` are the same 13 columns for the float32 data
model (``ops/f32.py``, the JAX package's ``build_f32_ops``), over the
``(3, Hp, pitch)`` float32 tensor; ``utils.image.from_planar_padded_f32``
crops and quantizes their outputs.
"""

from __future__ import annotations

from .. import spec
from ..runtime import tracing
from . import f32, point, window
from ..models import pipeline  # after point and window, which it imports

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
    "Convolution-3x3": (window.convolution, window.convolution_plain,
                        (spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT)),
    "Convolution-1x3+3x1": (window.convolution_separated,
                            window.conv_sep_plain,
                            (spec.BLUR_1X3_INT, spec.BLUR_3X1_INT,
                             spec.BLUR_SEP3_SHIFT)),
    "Convolution-5x5": (window.convolution, window.convolution_plain,
                        (spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT)),
    "Convolution-1x5+5x1": (window.convolution_separated,
                            window.conv_sep_plain,
                            (spec.BLUR_1X5_INT, spec.BLUR_5X1_INT,
                             spec.BLUR_SEP5_SHIFT)),
    "Gaussian-Blur-3x3": (window.gaussian_blur_3x3, window.blur3x3_plain, ()),
    # Looked up at call time: importing models.pipeline first imports this
    # package while that module is still half-built.
    "Fused-Pipeline": (lambda planar: pipeline.fused_pipeline(planar),
                       lambda planar: pipeline.fused_pipeline_plain(planar),
                       ()),
}


TABLE_F32 = {
    "Copy": (f32.copy, f32.copy_plain, ()),
    "Inversion": (f32.inversion, f32.inversion_plain, ()),
    "Grayscale": (f32.grayscale, f32.grayscale_plain, ()),
    "Threshold": (f32.threshold, f32.threshold_plain, ()),
    "Erosion-3x3-Cross": (f32.erosion, window.erosion_plain,
                          (spec.CROSS_MASK_3X3,)),
    "Erosion-3x3-Square": (f32.erosion, window.erosion_plain,
                           (spec.SQUARE_MASK_3X3,)),
    "Erosion-1x3+3x1-Square": (f32.erosion_separated,
                               window.erosion_sep_plain, ()),
    "Convolution-3x3": (f32.convolution, f32.conv_dense_plain,
                        (spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT)),
    "Convolution-1x3+3x1": (f32.convolution_separated, f32.conv_sep_plain,
                            (spec.BLUR_1X3_INT, spec.BLUR_3X1_INT,
                             spec.BLUR_SEP3_SHIFT)),
    "Convolution-5x5": (f32.convolution, f32.conv_dense_plain,
                        (spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT)),
    "Convolution-1x5+5x1": (f32.convolution_separated, f32.conv_sep_plain,
                            (spec.BLUR_1X5_INT, spec.BLUR_5X1_INT,
                             spec.BLUR_SEP5_SHIFT)),
    "Gaussian-Blur-3x3": (f32.gaussian_blur_3x3, f32.blur3x3_plain, ()),
    "Fused-Pipeline": (f32.fused_pipeline, f32.fused_pipeline_plain, ()),
}


def _bind(fn, args):
    return lambda planar: fn(planar, *args)


def _traced(fn, args):
    """``fn`` with ``args`` as the port's ``op`` span: the wrapper's
    checks, dispatch and argument packing, around its output's allocation
    and its launch."""
    bound = _bind(fn, args)

    def op(planar):
        if tracing.enabled or tracing.profiler._is_profiler_enabled:
            return tracing.call("op", bound, planar)
        return fn(planar, *args)
    return op


def _wrappers(table: dict) -> dict:
    """The CUDA kernel for a tensor on the card, the plain version for a
    CPU tensor."""
    return {col: _traced(wrapper, args)
            for col, (wrapper, _, args) in table.items()}


def _plains(table: dict) -> dict:
    """The plain PyTorch version of each op, on any device: what the
    kernels are held against on the card."""
    return {col: _bind(plain, args) for col, (_, plain, args) in table.items()}


OPS, PLAIN = _wrappers(TABLE), _plains(TABLE)
OPS_F32, PLAIN_F32 = _wrappers(TABLE_F32), _plains(TABLE_F32)
