"""flashdeconv_tpu_torch: the FlashDeconv solve on PyTorch and CUDA.

A port of :mod:`flashdeconv_tpu` to one NVIDIA H100 (Hopper, ``sm_90a``):
the single-device fit on any spatial graph, with each BCD sweep one launch
of a hand-written CUDA kernel — the fused banded sweep on wholly banded
grids, the coordinate-descent pass after plain-PyTorch neighbour sums on
every other graph. The host stages (gene selection, normalisation,
CountSketch, the spatial graph) are the port's own copies of the JAX
package's numpy/scipy/C++ modules; the port imports nothing of JAX or of
the JAX package.

Quick start::

    from flashdeconv_tpu_torch import FlashDeconv
    proportions = FlashDeconv(sketch_dim=512).fit_transform(Y, X, coords)
"""

from flashdeconv_tpu_torch.core.deconv import FlashDeconv

__all__ = ["FlashDeconv"]
