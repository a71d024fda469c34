"""Scanpy-style tools namespace of the port."""

from flashdeconv_tpu_torch.tl._deconvolve import deconvolve

__all__ = ["deconvolve"]
