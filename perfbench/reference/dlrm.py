"""DLRM (arXiv:1906.00091), written out in plain PyTorch, float32.

A bottom MLP (act after every layer, the last of width k) maps the dense
values to one more field beside the hashed fields' embeddings (one table
per field, rows 0..buckets, k wide); the dot products of every pair of
the F + 1 fields (i < j, row-major) and the bottom output feed the top
MLP (act layers, then top_dnn_w and top_dnn_w0); prob = sigmoid. The loss
is the weighted mean binary cross-entropy plus each regularizer times half
the sum of squares of its matrices. Parameter names are the port's; every
matrix product runs at the precision's ``gemm`` (``reference.common``).
"""

from __future__ import annotations

import torch

from .common import activation, add_bias, dense, half_l2, matmul, rows
from .xdeepfm import names


def _bottom_dims(cfg):
    hp = cfg["hparams"]
    return [cfg["data"]["n_dense"], *hp["bot_hidden_units"], hp["embedding_size"]]


def _top_dims(cfg):
    hp = cfg["hparams"]
    fields = cfg["data"]["n_cat"] + 1
    return [hp["embedding_size"] + fields * (fields - 1) // 2, *hp["top_hidden_units"]]


def param_shapes(cfg) -> dict:
    d, k = cfg["data"], cfg["hparams"]["embedding_size"]
    cats, _ = names(cfg)
    out = {f"{c}_feat_embed": ((cfg["num_buckets"] + 1, k), "glorot") for c in cats}
    bot = _bottom_dims(cfg)
    for i in range(len(bot) - 1):
        out[f"dlrm_bot_{i}_weights"] = ((bot[i], bot[i + 1]), "glorot")
        out[f"dlrm_bot_{i}_bias"] = ((bot[i + 1],), "zeros")
    top = _top_dims(cfg)
    for i in range(len(top) - 1):
        out[f"top_dnn_layer_{i}_weights"] = ((top[i], top[i + 1]), "glorot")
        out[f"top_dnn_layer_{i}_bias"] = ((top[i + 1],), "zeros")
    out["top_dnn_w"] = ((top[-1], 1), "glorot")
    out["top_dnn_w0"] = ((1,), "zeros")
    return out


def forward(params, cat, dense_x, cfg, prec) -> torch.Tensor:
    hp = cfg["hparams"]
    cats, _ = names(cfg)
    cat = cat.long()
    emb = torch.stack([rows(params[f"{c}_feat_embed"], cat[:, j]) for j, c in enumerate(cats)], 1)
    act = activation(hp["bot_activation"])
    x = dense_x
    for i in range(len(_bottom_dims(cfg)) - 1):
        x = act(add_bias(dense(x, params[f"dlrm_bot_{i}_weights"], prec),
                         params[f"dlrm_bot_{i}_bias"]))
    fields = torch.cat([emb, x[:, None, :]], 1)
    gram = matmul(fields, fields.transpose(1, 2), prec)
    r, c = torch.triu_indices(fields.shape[1], fields.shape[1], 1, device=cat.device)
    y = torch.cat([x, gram[:, r, c]], 1)
    act = activation(hp["top_activation"])
    for i in range(len(_top_dims(cfg)) - 1):
        y = act(add_bias(dense(y, params[f"top_dnn_layer_{i}_weights"], prec),
                         params[f"top_dnn_layer_{i}_bias"]))
    return torch.sigmoid(add_bias(dense(y, params["top_dnn_w"], prec)[:, 0], params["top_dnn_w0"]))


def l2(params, cfg) -> torch.Tensor:
    hp = cfg["hparams"]
    cats, _ = names(cfg)
    total = hp["embedding_l2_reg"] * sum(half_l2(params[f"{c}_feat_embed"]) for c in cats)
    total = total + hp["bot_l2_reg"] * sum(
        half_l2(params[f"dlrm_bot_{i}_weights"]) for i in range(len(_bottom_dims(cfg)) - 1))
    return total + hp["top_l2_reg"] * (half_l2(params["top_dnn_w"]) + sum(
        half_l2(params[f"top_dnn_layer_{i}_weights"]) for i in range(len(_top_dims(cfg)) - 1)))
