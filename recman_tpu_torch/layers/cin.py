"""Compressed Interaction Network — xDeepFM's core (arXiv:1803.05170).

Counterpart of ``recman_tpu/layers/cin.py``. Per layer:

    z_k[b, d, h*Hk + m] = x0[b, h, d] * xk[b, m, d]     # vector-wise outer
    fmap[b, d, o]       = sum_x z_k[b, d, x] * W_k[x, o] + bias_k[o]

then the activation, dropout (keep-probabilities, in training) and the
half-split: the first size/2 maps feed the next layer, the rest (all of
the last layer) are direct-connect outputs, sum-pooled over the
embedding dim and projected to one logit. Input dropout (keep[0]) comes
first.

Routing, as in the reference (:116-124, :170-185, :199):

- Field-major, (H, B*D) layout, when the multiplicands are bf16 (the
  default) and ``ops.cin_interact.pallas_cin_active`` holds for the
  widest fan-in (on unless ``pallas_cin(False)``/``fused_grad(False)``
  or a fan-in over 128), on either device:
  - the fused chain (``ops.cin_chain.cin_chain_fm``: K1 forward, K2
    backward) when ``CIN_CHAIN_MODE`` is "auto" and the chain takes the
    CIN: a supported activation name, in training no live in-chain
    dropout, and the reference's geometry rule, which K1 and K2 take
    whole;
  - otherwise the per-layer path: per layer ``cin_interact_fm`` (K4
    forward, K5 backward), then bias, activation and dropout in PyTorch.
    This takes a D that is not a power of two, live in-chain dropout and
    a callable activation.
- Batch-major, (B, D, H) layout, otherwise (``compute_dtype="float32"``,
  a fan-in over 128, the switches off): plain PyTorch on either device,
  the counterpart of the reference's XLA einsum.

On a CPU tensor every kernel is its plain twin. ``remat`` recomputes each
whole layer in the backward (``torch.utils.checkpoint``) on the per-layer
and batch-major paths; the chain ignores it, as in the reference.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.cin_chain import chain_supported, cin_chain_fm
from ..ops.cin_interact import cin_interact, cin_interact_fm, pallas_cin_active
from ..utils import glorot_normal, glorot_uniform, l2_loss, split_rng
from .common import apply_mask, dropout, dropout_mask, resolve_activation

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# The fused chain: "auto" takes it where it is eligible, "off" runs the
# per-layer kernels instead (reference :45-53).
CIN_CHAIN_MODE = "auto"


class CIN:
    """Param names match the reference: ``cin_filter_{i}`` (H0*Hk, size),
    ``cin_bias_{i}`` (size,), ``cin_w`` (final_size, 1), ``cin_w0`` (1,)."""

    def __init__(
        self,
        field_size,
        cross_layer_units,
        activation,
        dropout_keep,
        l2_reg=1e-5,
        prefix="",
        compute_dtype="bfloat16",
        remat=False,
    ):
        assert len(cross_layer_units) > 0
        assert len(cross_layer_units) + 1 == len(dropout_keep)
        for size in cross_layer_units[:-1]:
            assert size % 2 == 0, "non-final CIN layer width must be even (half-split)"

        self.field_size = field_size
        self.cross_layer_units = tuple(cross_layer_units)
        self.activation = resolve_activation(activation)
        # the fused chain implements the activation in the kernel; it
        # needs the NAME (a callable takes the per-layer path)
        self._act_name = activation if isinstance(activation, str) else None
        self.dropout_keep = tuple(dropout_keep)
        self.l2_reg = l2_reg
        self.prefix = prefix
        self.compute_dtype = _DTYPES[compute_dtype] if compute_dtype else torch.float32
        self.remat = remat

        # field_nums[i] = H_i, the fan-in of layer i
        self.field_nums = [field_size]
        final_size = 0
        for i, size in enumerate(self.cross_layer_units):
            self.field_nums.append(size // 2)
            final_size += size // 2 if i != len(self.cross_layer_units) - 1 else size
        self.final_size = final_size

    def init(self, generator, device=None) -> dict:
        keys = split_rng(generator, len(self.cross_layer_units) + 1)
        params = {}
        h0 = self.field_nums[0]
        for i, size in enumerate(self.cross_layer_units):
            hk = self.field_nums[i]
            params[f"{self.prefix}cin_filter_{i}"] = glorot_normal(
                keys[i], (h0 * hk, size), device=device
            )
            params[f"{self.prefix}cin_bias_{i}"] = torch.zeros(
                (size,), dtype=torch.float32, device=device
            )
        params[f"{self.prefix}cin_w"] = glorot_uniform(
            keys[-1], (self.final_size, 1), device=device
        )
        params[f"{self.prefix}cin_w0"] = torch.zeros((1,), dtype=torch.float32, device=device)
        return params

    def _layer_params(self, params):
        n = len(self.cross_layer_units)
        return (
            [params[f"{self.prefix}cin_filter_{i}"] for i in range(n)],
            [params[f"{self.prefix}cin_bias_{i}"] for i in range(n)],
        )

    def _head(self, params, pooled):
        return pooled @ params[f"{self.prefix}cin_w"] + params[f"{self.prefix}cin_w0"]

    def _chain_eligible(self, training, b, d) -> bool:
        if CIN_CHAIN_MODE == "off" or self._act_name is None:
            return False
        if training and any(k < 1.0 for k in self.dropout_keep[1:]):
            return False
        return chain_supported(
            self.field_size, self.cross_layer_units, d, b * d, self._act_name
        )

    def apply(self, params, inputs, training=False, generator=None):
        """inputs (B, F, D) f32 -> CIN logit (B, 1)."""
        assert inputs.dim() == 3
        b, h0, d = inputs.shape
        x0 = dropout(generator, inputs, self.dropout_keep[0], training)
        if self.compute_dtype == torch.bfloat16 and pallas_cin_active(max(self.field_nums)):
            x0c = x0.permute(1, 0, 2).reshape(h0, b * d).contiguous()
            if self._chain_eligible(training, b, d):
                return self._apply_chain(params, x0c, d)
            return self._apply_per_layer(params, x0c, d, training, generator)
        return self._apply_batch_major(params, x0, training, generator)

    def _apply_chain(self, params, x0c, d):
        ws, bs = self._layer_params(params)
        pooled = cin_chain_fm(x0c, ws, bs, self.cross_layer_units, d, self._act_name)
        return self._head(params, torch.cat(pooled, dim=1))  # (B, final_size)

    def _layers(self, params, x0, fmap_shape, layer, split, training, generator):
        """The per-layer loop of both layouts: each layer's fmap from
        ``layer(x0, xk, W, b, mask, keep)``, its dropout mask drawn first
        (outside a rematerialized layer, whose recompute must apply the
        same mask), then the half-split by ``split(fmap, half)``. Returns
        the direct-connect blocks."""
        ws, bs = self._layer_params(params)
        xk, finals = x0, []
        last = len(self.cross_layer_units) - 1
        for i, size in enumerate(self.cross_layer_units):
            keep = self.dropout_keep[i + 1]
            mask = dropout_mask(generator, fmap_shape(size), x0.device, keep, training)
            if self.remat:
                # the whole layer, not only the interaction, is recomputed
                # in the backward (reference :141-150)
                fmap = checkpoint(layer, x0, xk, ws[i], bs[i], mask, keep, use_reentrant=False)
            else:
                fmap = layer(x0, xk, ws[i], bs[i], mask, keep)
            if i == last:
                finals.append(fmap)
            else:
                xk, direct = split(fmap, size // 2)
                finals.append(direct)
        return finals

    def _apply_per_layer(self, params, x0c, d, training, generator):
        """Field-major, one K4/K5 interaction per layer (reference
        :220-272): each (O, B*D) fmap's leading half is the next layer's
        xk, a slice; the direct blocks pool over D per block."""
        bd = x0c.shape[1]
        act = self.activation

        def layer(x0c, xkc, w, bias, mask, keep):
            return apply_mask(act(cin_interact_fm(x0c, xkc, w) + bias[:, None]), mask, keep)

        finals = self._layers(params, x0c, lambda o: (o, bd), layer,
                              lambda f, half: (f[:half], f[half:]), training, generator)
        pooled = torch.cat([f.reshape(f.shape[0], bd // d, d).sum(2) for f in finals])
        return self._head(params, pooled.t())  # (final_size, B) -> (B, 1)

    def _apply_batch_major(self, params, x0, training=False, generator=None):
        """Plain einsum chain in (B, D, H) layout."""
        x0t = x0.transpose(1, 2)  # (B, D, H0)
        b, d, _ = x0t.shape
        act, dtype = self.activation, self.compute_dtype

        def layer(x0t, xkt, w, bias, mask, keep):
            return apply_mask(act(cin_interact(x0t, xkt, w, dtype=dtype) + bias), mask, keep)

        finals = self._layers(params, x0t, lambda o: (b, d, o), layer,
                              lambda f, half: (f[:, :, :half], f[:, :, half:]),
                              training, generator)
        pooled = torch.cat(finals, dim=2).sum(dim=1)  # (B, final_size)
        return self._head(params, pooled)

    def l2(self, params):
        """Filters + head (reference layers.py:762-777)."""
        total = self.l2_reg * l2_loss(params[f"{self.prefix}cin_w"])
        for i in range(len(self.cross_layer_units)):
            total = total + self.l2_reg * l2_loss(params[f"{self.prefix}cin_filter_{i}"])
        return total
