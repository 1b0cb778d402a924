"""Shared layer utilities: keep-probability dropout, activations by name.

Dropout arguments are KEEP probabilities, as in the reference
(``recman_tpu/layers/common.py:14-23``): keep=1.0 is a no-op, keep=0.8
keeps 80% of units.
"""

from __future__ import annotations

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


ACTIVATIONS = {
    "relu": torch.relu,
    "leaky_relu": leaky_relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def resolve_activation(act):
    """Accept either a callable or a registry name. ``"dice"`` is not
    ported yet."""
    if callable(act):
        return act
    if act == "dice":
        raise NotImplementedError("Dice activation not ported yet")
    return ACTIVATIONS[act]
