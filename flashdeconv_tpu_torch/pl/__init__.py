"""Scanpy-style plotting layer of the port (matplotlib optional dependency).

The port's copy of :mod:`flashdeconv_tpu.pl`: the spatial map, the mean
composition and the lambda-path diagnostics of a fit.
"""

from flashdeconv_tpu_torch.pl._plots import composition, lambda_path, spatial

__all__ = ["spatial", "composition", "lambda_path"]
