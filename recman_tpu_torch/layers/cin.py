"""Compressed Interaction Network — xDeepFM's core (arXiv:1803.05170).

Counterpart of ``recman_tpu/layers/cin.py``. Per layer:

    z_k[b, d, h*Hk + m] = x0[b, h, d] * xk[b, m, d]     # vector-wise outer
    fmap[b, d, o]       = sum_x z_k[b, d, x] * W_k[x, o] + bias_k[o]

then the activation, dropout (keep-probabilities, in training) and the
half-split: the first size/2 maps feed the next layer, the rest (all of
the last layer) are direct-connect outputs, sum-pooled over the
embedding dim and projected to one logit. Input dropout (keep[0]) comes
first.

Routing, as in the reference: with bf16 multiplicands (the default) the
tower goes field-major through ``ops.cin_chain.cin_chain_fm`` when the
chain takes it: a supported activation name, the geometry, and in
training no live in-chain dropout (every keep past index 0 >= 1,
reference :170-185). On a CUDA tensor that is K1 forward and K2
backward, on a CPU tensor their plain versions. Anything else runs the
batch-major plain path on the CPU and raises on CUDA, where the
reference would use its per-layer kernel K4, not ported yet.
``compute_dtype="float32"`` keeps the batch-major path everywhere, as in
the reference.
"""

from __future__ import annotations

import torch

from ..ops.cin_chain import chain_supported, cin_chain_fm
from ..ops.cin_interact import cin_interact
from ..utils import glorot_normal, glorot_uniform, l2_loss
from .common import dropout, resolve_activation

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    ):
        assert len(cross_layer_units) > 0
        assert len(cross_layer_units) + 1 == len(dropout_keep)
        for size in cross_layer_units[:-1]:
            assert size % 2 == 0, "non-final CIN layer width must be even (half-split)"

        self.field_size = field_size
        self.cross_layer_units = tuple(cross_layer_units)
        self.activation = resolve_activation(activation)
        # the fused chain implements the activation in the kernel; it
        # needs the NAME (a callable takes the batch-major path)
        self._act_name = activation if isinstance(activation, str) else None
        self.dropout_keep = tuple(dropout_keep)
        self.l2_reg = l2_reg
        self.prefix = prefix
        self.compute_dtype = _DTYPES[compute_dtype] if compute_dtype else torch.float32

        # field_nums[i] = H_i, the fan-in of layer i
        self.field_nums = [field_size]
        final_size = 0
        for i, size in enumerate(self.cross_layer_units):
            self.field_nums.append(size // 2)
            final_size += size // 2 if i != len(self.cross_layer_units) - 1 else size
        self.final_size = final_size

    def init(self, generator, device=None) -> dict:
        params = {}
        h0 = self.field_nums[0]
        for i, size in enumerate(self.cross_layer_units):
            hk = self.field_nums[i]
            params[f"{self.prefix}cin_filter_{i}"] = glorot_normal(
                generator, (h0 * hk, size), device=device
            )
            params[f"{self.prefix}cin_bias_{i}"] = torch.zeros(
                (size,), dtype=torch.float32, device=device
            )
        params[f"{self.prefix}cin_w"] = glorot_uniform(
            generator, (self.final_size, 1), device=device
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
        if self.compute_dtype != torch.bfloat16 or self._act_name is None:
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
        if self._chain_eligible(training, b, d):
            return self._apply_field_major(params, x0)
        if inputs.is_cuda and self.compute_dtype == torch.bfloat16:
            raise NotImplementedError(
                "CIN outside the fused chain needs the per-layer kernel K4 "
                "(recman_tpu/ops/cin_interact.py:_fwd_kernel), not ported "
                f"yet: F={h0}, units={self.cross_layer_units}, D={d}, "
                f"B*D={b * d}, activation={self._act_name}, "
                f"training={training}, keeps={self.dropout_keep}"
            )
        return self._apply_batch_major(params, x0, training, generator)

    def _apply_field_major(self, params, inputs):
        b, h0, d = inputs.shape
        x0c = inputs.permute(1, 0, 2).reshape(h0, b * d).contiguous()
        ws, bs = self._layer_params(params)
        pooled = cin_chain_fm(x0c, ws, bs, self.cross_layer_units, d, self._act_name)
        return self._head(params, torch.cat(pooled, dim=1))  # (B, final_size)

    def _apply_batch_major(self, params, inputs, training=False, generator=None):
        """Plain einsum chain in (B, D, H) layout."""
        x0t = inputs.transpose(1, 2)  # (B, D, H0)
        xkt = x0t
        finals = []
        ws, bs = self._layer_params(params)
        for i, size in enumerate(self.cross_layer_units):
            pre = cin_interact(x0t, xkt, ws[i], dtype=self.compute_dtype) + bs[i]
            fmap = dropout(generator, self.activation(pre), self.dropout_keep[i + 1],
                           training)  # (B, D, size)
            if i != len(self.cross_layer_units) - 1:
                xkt = fmap[:, :, : size // 2]
                finals.append(fmap[:, :, size // 2:])
            else:
                finals.append(fmap)
        pooled = torch.cat(finals, dim=2).sum(dim=1)  # (B, final_size)
        return self._head(params, pooled)

    def l2(self, params):
        """Filters + head (reference layers.py:762-777)."""
        total = self.l2_reg * l2_loss(params[f"{self.prefix}cin_w"])
        for i in range(len(self.cross_layer_units)):
            total = total + self.l2_reg * l2_loss(params[f"{self.prefix}cin_filter_{i}"])
        return total
