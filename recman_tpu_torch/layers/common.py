"""Shared layer utilities: keep-probability dropout, activations by name,
Dice (``batch_moments``, ``dice``, and ``dice_params`` / ``apply_dice``
for the layers that hold Dice params), and ``DeviceIndex`` /
``triu_pairs``, the static gathers' indices.

Dropout arguments are KEEP probabilities, as in the reference
(``recman_tpu/layers/common.py:14-23``): keep=1.0 is a no-op, keep=0.8
keeps 80% of units.
"""

from __future__ import annotations

import numpy as np
import torch


def dropout(generator, x, keep_prob: float, training: bool):
    """Inverted dropout with keep-probability semantics.

    A no-op when not training, when keep_prob >= 1 or without a
    generator, as in the reference. The mask is drawn on ``x``'s device
    from ``generator``, which must live on that device (a CUDA tensor
    takes ``torch.Generator(device="cuda")``). It cannot match the
    reference's ``jax.random`` bits, so parity runs keep every keep at 1.
    """
    return apply_mask(x, dropout_mask(generator, x.shape, x.device, keep_prob, training),
                      keep_prob)


def dropout_mask(generator, shape, device, keep_prob: float, training: bool):
    """The keep mask ``dropout`` draws for a tensor of ``shape`` on
    ``device``, or None where ``dropout`` is a no-op. Drawn apart from its
    use so that a rematerialized layer reuses it (layers/cin.py)."""
    if not training or keep_prob >= 1.0 or generator is None:
        return None
    if generator.device.type != torch.device(device).type:
        raise ValueError(
            f"dropout: generator on {generator.device}, tensor on {device}; "
            "draw the mask with a generator on the tensor's device"
        )
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def apply_mask(x, mask, keep_prob: float):
    """Inverted dropout of ``x`` by a mask from ``dropout_mask``."""
    if mask is None:
        return x
    return torch.where(mask, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def leaky_relu(x):
    """Slope 0.2, the reference's tf.nn.leaky_relu default
    (recman_tpu/layers/common.py:35-38) — not torch's 0.01."""
    return torch.nn.functional.leaky_relu(x, negative_slope=0.2)


def batch_moments(x):
    """Per-unit mean and population variance over the batch axis, the
    moments Dice normalizes with in training (``jnp.var`` is the
    population variance, hence ``correction=0``). The gradient flows
    through both, as in the reference."""
    return x.mean(dim=0), x.var(dim=0, correction=0)


def dice(x, alpha, mean=None, var=None, eps=1e-8):
    """Dice activation (DIN paper, arXiv:1706.06978 §4.3; reference
    ``recman_tpu/layers/common.py:46-62``): p = sigmoid((x - mean) *
    rsqrt(var + eps)), out = p * x + (1 - p) * alpha * x. ``mean`` and
    ``var`` None take the batch's moments (training); the stored moments
    make inference independent of which rows share a batch."""
    if mean is None or var is None:
        mean, var = batch_moments(x)
    p = torch.sigmoid((x - mean) * torch.rsqrt(var + eps))
    return p * x + (1.0 - p) * alpha * x


def dice_params(prefix, i, width, device=None) -> dict:
    """Layer ``i``'s Dice params: ``{prefix}_alpha_{i}`` (zeros) and the
    frozen inference moments ``{prefix}_mean_{i}`` (zeros) and
    ``{prefix}_var_{i}`` (ones), which get no gradient."""
    def full(v):
        return torch.full((width,), v, dtype=torch.float32, device=device)

    return {f"{prefix}_alpha_{i}": full(0.0), f"{prefix}_mean_{i}": full(0.0),
            f"{prefix}_var_{i}": full(1.0)}


def apply_dice(params, prefix, i, x, training, moment_capture=None):
    """Dice of layer ``i``'s pre-activations ``x`` (rows on axis 0): the
    batch's moments in training, recorded into ``moment_capture`` when
    given, the stored ``{prefix}_mean_{i}`` / ``{prefix}_var_{i}`` at
    inference (reference dnn.py:88-101, din_attention.py:99-111)."""
    if training:
        mean, var = batch_moments(x)
        if moment_capture is not None:
            moment_capture[f"{prefix}_mean_{i}"] = mean
            moment_capture[f"{prefix}_var_{i}"] = var
    else:
        mean, var = params[f"{prefix}_mean_{i}"], params[f"{prefix}_var_{i}"]
    return dice(x, params[f"{prefix}_alpha_{i}"], mean, var)


ACTIVATIONS = {
    "relu": torch.relu,
    "leaky_relu": leaky_relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def resolve_activation(act):
    """Accept either a callable or a registry name. ``"dice"`` resolves
    to ``dice`` with batch moments; the layers that hold Dice params
    (``DNN``, ``ASPLayer``) apply it themselves."""
    if callable(act):
        return act
    if act == "dice":
        return dice
    return ACTIVATIONS[act]


class DeviceIndex:
    """Constant int64 index vectors, a static gather's, copied to each
    device once; ``on(device)`` gives them as a tuple of tensors."""

    def __init__(self, *indices):
        self.indices = tuple(np.asarray(i, dtype=np.int64) for i in indices)
        self._on = {}

    def on(self, device):
        if device not in self._on:
            # normal tensors even when first built under inference_mode, so
            # that a later training step may save them for its backward
            with torch.inference_mode(False):
                self._on[device] = tuple(torch.as_tensor(i, device=device) for i in self.indices)
        return self._on[device]


def triu_pairs(num_fields: int) -> DeviceIndex:
    """The field pairs (i, j), i < j, of ``num_fields`` fields as (rows,
    cols), in ``np.triu_indices(num_fields, 1)``'s row-major order: the
    reference's static pair gathers (layers/afm.py, product.py, senet.py,
    models/dlrm.py)."""
    return DeviceIndex(*np.triu_indices(int(num_fields), k=1))
