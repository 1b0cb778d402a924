from .initializers import calc_fan, glorot_normal, glorot_uniform, he_normal, he_uniform
from .jax_random import JaxKey, split_rng
from .numerics import (
    bce_per_example,
    binary_cross_entropy,
    compute_hidden_units_s1,
    compute_hidden_units_s2,
    count_parameters,
    l2_loss,
    mean_squared_error,
    mse_per_example,
    split_train_test,
)

__all__ = [
    "JaxKey",
    "bce_per_example",
    "binary_cross_entropy",
    "calc_fan",
    "compute_hidden_units_s1",
    "compute_hidden_units_s2",
    "count_parameters",
    "glorot_normal",
    "glorot_uniform",
    "he_normal",
    "he_uniform",
    "l2_loss",
    "mean_squared_error",
    "mse_per_example",
    "split_rng",
    "split_train_test",
]
