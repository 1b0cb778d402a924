from .initializers import calc_fan, glorot_normal, glorot_uniform
from .numerics import (
    bce_per_example,
    binary_cross_entropy,
    l2_loss,
    mean_squared_error,
    mse_per_example,
)

__all__ = [
    "bce_per_example",
    "binary_cross_entropy",
    "calc_fan",
    "glorot_normal",
    "glorot_uniform",
    "l2_loss",
    "mean_squared_error",
    "mse_per_example",
]
