"""xDeepFM (arXiv:1803.05170), written out in plain PyTorch, float32.

prob = sigmoid(linear + cin + dnn), on one embedding table per hashed
field (rows 0..buckets, k wide, no bias):

- linear: sum_j w[j * V + id_j] over the hashed fields, plus sum_i
  w[F * V + i] * dense_i, plus w0 (V = buckets + 1);
- CIN on x0 = the fields' embeddings (F, k): layer i's maps are act(sum
  over (h, m) of x0[h] * x_i[m] * W_i[h * H_i + m] + b_i), the first half
  of a non-final layer's maps feeding the next layer and the rest, and all
  of the last layer's, summed over the k positions and projected by
  cin_w, plus cin_w0;
- DNN on [the embeddings flattened field by field, the dense values]: act
  layers, then dnn_w and dnn_w0;
- loss: the weighted mean binary cross-entropy plus each regularizer times
  half the sum of squares of its matrices (tables, linear_w, the CIN's
  filters and cin_w, the DNN's layer weights and dnn_w).

Parameter names are the port's, the interface by which both sides get the
same weights. The CIN's products run at the precision's ``cin``, every
other matrix product at its ``gemm`` (``reference.common``).
"""

from __future__ import annotations

import torch

from ..spec import field_names as names
from .common import activation, add_bias, cin_layer, dense, half_l2, note_terms, rows


def param_shapes(cfg) -> dict:
    hp, d = cfg["hparams"], cfg["data"]
    cats, _ = names(cfg)
    k, f, v = hp["embedding_size"], d["n_cat"], cfg["num_buckets"] + 1
    out = {f"{c}_feat_embed": ((v, k), "glorot") for c in cats}
    out["linear_w"] = ((f * v + d["n_dense"],), "zeros")
    out["linear_w0"] = ((1,), "zeros")
    hk, final = f, 0
    units = hp["cin_cross_layer_units"]
    for i, o in enumerate(units):
        out[f"cin_filter_{i}"] = ((f * hk, o), "glorot")
        out[f"cin_bias_{i}"] = ((o,), "zeros")
        final += o if i == len(units) - 1 else o // 2
        hk = o // 2
    out["cin_w"] = ((final, 1), "glorot")
    out["cin_w0"] = ((1,), "zeros")
    dims = [f * k + d["n_dense"], *hp["deep_hidden_units"]]
    for i in range(len(dims) - 1):
        out[f"dnn_layer_{i}_weights"] = ((dims[i], dims[i + 1]), "glorot")
        out[f"dnn_layer_{i}_bias"] = ((dims[i + 1],), "zeros")
    out["dnn_w"] = ((dims[-1], 1), "glorot")
    out["dnn_w0"] = ((1,), "zeros")
    return out


def forward(params, cat, dense_x, cfg, prec) -> torch.Tensor:
    """cat (B, F) ids, dense_x (B, n_dense) -> (B,) probabilities."""
    hp = cfg["hparams"]
    cats, _ = names(cfg)
    b, f = cat.shape
    v = cfg["num_buckets"] + 1
    cat = cat.long()
    emb = torch.stack([rows(params[f"{c}_feat_embed"], cat[:, j]) for j, c in enumerate(cats)], 1)

    lw = params["linear_w"]
    scaled = dense_x * lw[f * v:]
    note_terms(scaled, lw, lambda g: (f * v + torch.arange(scaled.shape[1], device=g.device),
                                      (g * dense_x.abs()).sum(0)))
    linear = scaled.sum(1) + rows(lw, cat + v * torch.arange(f, device=cat.device)).sum(1)
    linear = add_bias(linear, params["linear_w0"])

    kk = emb.shape[2]
    x0 = emb.transpose(1, 2).reshape(b * kk, f)  # rows (b, position), fields along
    act = activation(hp["cin_activation"])
    units = hp["cin_cross_layer_units"]
    xk, pooled = x0, []
    for i, o in enumerate(units):
        fmap = act(add_bias(cin_layer(x0, xk, params[f"cin_filter_{i}"], prec),
                            params[f"cin_bias_{i}"]))
        if i < len(units) - 1:
            xk, direct = fmap[:, : o // 2], fmap[:, o // 2:]
        else:
            direct = fmap
        pooled.append(direct.reshape(b, kk, -1).sum(1))
    cin = add_bias(dense(torch.cat(pooled, 1), params["cin_w"], prec)[:, 0], params["cin_w0"])

    act = activation(hp["deep_activation"])
    y = torch.cat([emb.reshape(b, f * kk), dense_x], 1)
    for i in range(len(hp["deep_hidden_units"])):
        y = act(add_bias(dense(y, params[f"dnn_layer_{i}_weights"], prec),
                         params[f"dnn_layer_{i}_bias"]))
    dnn = add_bias(dense(y, params["dnn_w"], prec)[:, 0], params["dnn_w0"])
    return torch.sigmoid(linear + cin + dnn)


def l2(params, cfg) -> torch.Tensor:
    hp = cfg["hparams"]
    cats, _ = names(cfg)
    total = hp["embedding_l2_reg"] * sum(half_l2(params[f"{c}_feat_embed"]) for c in cats)
    total = total + hp["linear_l2_reg"] * half_l2(params["linear_w"])
    n_cin = len(hp["cin_cross_layer_units"])
    total = total + hp["cin_l2_reg"] * (half_l2(params["cin_w"]) + sum(
        half_l2(params[f"cin_filter_{i}"]) for i in range(n_cin)))
    n_dnn = len(hp["deep_hidden_units"])
    return total + hp["deep_l2_reg"] * (half_l2(params["dnn_w"]) + sum(
        half_l2(params[f"dnn_layer_{i}_weights"]) for i in range(n_dnn)))
