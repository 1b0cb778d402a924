"""CrossNetV2, the DCN-V2 cross tower (arXiv:2008.13535), and GDCN's gate.

Counterpart of ``recman_tpu/layers/cross_v2.py``. Each layer is a full
(or low-rank) weight matrix, optionally a mixture of low-rank experts
with a softmax gate:

    full:      x_{l+1} = x0 * (x_l W_l + b_l) + x_l             W_l (d, d)
    low-rank:  W_l = V_l U_l^T                                   (d, r) each
    mixture:   x_{l+1} = x0 * (sum_e g_e(x_l) (x_l V_e) U_e^T + b_l) + x_l
    gated:     x_{l+1} = x0 * (x_l W_l + b_l) * sigmoid(x_l Wg_l) + x_l

(GDCN, arXiv:2311.04635, full rank only). Plain PyTorch: every variant is
dense f32 matmuls over (B, d).
"""

from __future__ import annotations

import torch

from ..utils import glorot_normal, l2_loss, split_rng


class CrossNetV2:
    """Params per layer i (and expert e): ``cross_v2_b_{i}`` (d,); full
    rank ``cross_v2_w_{i}`` (d, d) and, gated, ``cross_v2_wg_{i}`` (d, d);
    low rank ``cross_v2_u_{i}_{e}`` and ``cross_v2_v_{i}_{e}`` (d, r) and,
    with E > 1 experts, ``cross_v2_gate_{i}`` (d, E). Head ``cross_v2_w``
    (d, 1), ``cross_v2_w0`` (1,)."""

    def __init__(self, input_dim, num_layers=3, rank=None, num_experts=1,
                 l2_reg=0.0, gated=False, prefix=""):
        assert num_layers > 0 and num_experts >= 1
        assert rank is not None or num_experts == 1, (
            "mixture-of-experts requires low-rank experts (set rank)"
        )
        assert not (gated and rank is not None), (
            "the GDCN gate (arXiv:2311.04635) is defined on full-rank cross layers"
        )
        self.input_dim = input_dim
        self.num_layers = num_layers
        self.rank = rank
        self.num_experts = num_experts
        self.l2_reg = l2_reg
        self.gated = gated
        self.prefix = prefix

    def _layer_param_names(self, i):
        p = self.prefix
        names = [f"{p}cross_v2_b_{i}"]
        if self.rank is None:
            names.append(f"{p}cross_v2_w_{i}")
            if self.gated:
                names.append(f"{p}cross_v2_wg_{i}")
        else:
            for e in range(self.num_experts):
                names += [f"{p}cross_v2_u_{i}_{e}", f"{p}cross_v2_v_{i}_{e}"]
            if self.num_experts > 1:
                names.append(f"{p}cross_v2_gate_{i}")
        return names

    def layer_weight_names(self):
        """Every layer's matrices, no bias: what the L2 covers besides the
        head."""
        return [n for i in range(self.num_layers) for n in self._layer_param_names(i)
                if not n.endswith(f"_b_{i}")]

    def init(self, generator, device=None) -> dict:
        """Keys split as the reference splits them: L * (2E + 2) + 1, taken
        in order, some never used."""
        d, r, p = self.input_dim, self.rank, self.prefix
        keys = iter(split_rng(generator, self.num_layers * (2 * self.num_experts + 2) + 1))
        params = {}
        for i in range(self.num_layers):
            params[f"{p}cross_v2_b_{i}"] = torch.zeros((d,), dtype=torch.float32, device=device)
            if r is None:
                params[f"{p}cross_v2_w_{i}"] = glorot_normal(next(keys), (d, d), device=device)
                if self.gated:
                    params[f"{p}cross_v2_wg_{i}"] = glorot_normal(next(keys), (d, d),
                                                                  device=device)
            else:
                for e in range(self.num_experts):
                    params[f"{p}cross_v2_u_{i}_{e}"] = glorot_normal(next(keys), (d, r),
                                                                     device=device)
                    params[f"{p}cross_v2_v_{i}_{e}"] = glorot_normal(next(keys), (d, r),
                                                                     device=device)
                if self.num_experts > 1:
                    params[f"{p}cross_v2_gate_{i}"] = glorot_normal(
                        next(keys), (d, self.num_experts), device=device)
        params[f"{p}cross_v2_w"] = glorot_normal(next(keys), (d, 1), device=device)
        params[f"{p}cross_v2_w0"] = torch.zeros((1,), dtype=torch.float32, device=device)
        return params

    def features(self, params, inputs):
        """The tower's (B, d) output without the head: DCN-V2's stacked
        structure feeds it to the deep tower."""
        assert inputs.dim() == 2  # (B, d)
        p = self.prefix
        x0 = x = inputs
        for i in range(self.num_layers):
            info_gate = None
            if self.rank is None:
                inter = x @ params[f"{p}cross_v2_w_{i}"]
                if self.gated:
                    info_gate = torch.sigmoid(x @ params[f"{p}cross_v2_wg_{i}"])
            else:
                outs = [(x @ params[f"{p}cross_v2_v_{i}_{e}"]) @ params[f"{p}cross_v2_u_{i}_{e}"].T
                        for e in range(self.num_experts)]
                if self.num_experts == 1:
                    inter = outs[0]
                else:
                    gate = torch.softmax(x @ params[f"{p}cross_v2_gate_{i}"], dim=-1)  # (B, E)
                    inter = outs[0] * gate[:, 0:1]
                    for e in range(1, self.num_experts):
                        inter = inter + outs[e] * gate[:, e:e + 1]
            cross = x0 * (inter + params[f"{p}cross_v2_b_{i}"])
            if info_gate is not None:
                cross = cross * info_gate
            x = cross + x
        return x

    def apply(self, params, inputs, training=False, generator=None):
        x = self.features(params, inputs)
        return x @ params[f"{self.prefix}cross_v2_w"] + params[f"{self.prefix}cross_v2_w0"]

    def l2(self, params):
        """The head and every layer's matrices, no bias."""
        total = self.l2_reg * l2_loss(params[f"{self.prefix}cross_v2_w"])
        for name in self.layer_weight_names():
            total = total + self.l2_reg * l2_loss(params[name])
        return total
