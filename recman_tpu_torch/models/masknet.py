"""MaskNet (arXiv:2102.07619).

Counterpart of ``recman_tpu/models/masknet.py``: instance-guided masks
over layer-normalized field embeddings (``layers/masknet.py``), in the
paper's two topologies:

- ``variant="serial"`` (SerMaskNet): MaskBlocks chained, block i reading
  block i-1's output; every mask reads the raw embeddings; a linear head
  (``masknet_out_w``, ``masknet_out_b``) gives the logit;
- ``variant="parallel"`` (ParaMaskNet): every block reads the
  LN-embeddings; the concatenated outputs feed a DNN head
  (``prefix="masknet_head_"``).

Dense features join the mask input and the first block's input as extra
columns.
"""

from __future__ import annotations

import torch

from ..config import MaskNetHyperParams as HP
from ..device import resolve_device
from ..layers import DNN, EmbeddingLayer, LayerNorm, MaskBlock, PredictionLayer, dnn_combine
from ..utils import glorot_normal, l2_loss, split_rng
from .base import Model


class MaskNet(Model):
    name = "masknet"

    def __init__(self, feat_dict, hparams: dict | None = None, task="classification"):
        super().__init__(feat_dict, task)
        hp = dict(HP().defaults())
        hp.update(hparams or {})
        self.hparams = hp
        k = hp[HP.EmbeddingSize]
        self.variant = hp[HP.Variant]
        assert self.variant in ("serial", "parallel"), self.variant

        self.embeddings = EmbeddingLayer(feat_dict, k, hp[HP.EmbeddingL2Reg], use_bias=False)
        # the mask input's and the first block input's width
        emb_dim = self.embeddings.field_size * k + len(feat_dict.dense_feats)
        self.emb_ln = LayerNorm(k, prefix="masknet_emb_")

        dims = tuple(int(d) for d in hp[HP.BlockDims])
        self.blocks = []
        prev = emb_dim
        for i, d in enumerate(dims):
            self.blocks.append(MaskBlock(
                mask_input_dim=emb_dim,
                input_dim=emb_dim if self.variant == "parallel" else prev,
                output_dim=d,
                agg_dim=int(hp[HP.AggDim]),
                l2_reg=hp[HP.MaskL2Reg],
                prefix=f"masknet_block_{i}_",
            ))
            prev = d

        if self.variant == "parallel":
            self.head_dnn = DNN(
                input_dim=sum(dims),
                hidden_units=hp[HP.DeepHiddenUnits],
                dropout_keep=hp[HP.DeepDropOut],
                activation=hp[HP.DeepActivation],
                l2_reg=hp[HP.DeepL2Reg],
                prefix="masknet_head_",
            )
        else:
            self.head_dnn = None
            self._out_dim = dims[-1]
        self.head = PredictionLayer(task)

    def init_params(self, generator, device=None) -> dict:
        """len(blocks) + 2 keys: the embeddings take the first, the blocks
        the next, the head the last."""
        device = resolve_device(device)
        keys = split_rng(generator, len(self.blocks) + 2)
        params = {}
        params.update(self.embeddings.init(keys[0], device))
        params.update(self.emb_ln.init(device))
        for blk, key in zip(self.blocks, keys[1:-1]):
            params.update(blk.init(key, device))
        if self.head_dnn is not None:
            params.update(self.head_dnn.init(keys[-1], device))
        else:
            params["masknet_out_w"] = glorot_normal(keys[-1], (self._out_dim, 1), device=device)
            params["masknet_out_b"] = torch.zeros((1,), dtype=torch.float32, device=device)
        params.update(self.head.init(device))
        return params

    def apply(self, params, batch, training=False, generator=None, linear_override=None):
        feat_embeds, _ = self.embeddings.apply(params, batch)  # (B, F, k)
        dense = self.dense_columns(batch)
        raw_flat = dnn_combine([feat_embeds] + dense)
        ln_flat = dnn_combine([self.emb_ln.apply(params, feat_embeds)] + dense)
        if self.variant == "parallel":
            outs = [blk.apply(params, ln_flat, raw_flat) for blk in self.blocks]
            logit = self.head_dnn.apply(params, torch.cat(outs, dim=1), training=training,
                                        generator=generator)
        else:
            x = ln_flat
            for blk in self.blocks:
                x = blk.apply(params, x, raw_flat)
            logit = x @ params["masknet_out_w"] + params["masknet_out_b"]
        return self.head.apply(params, logit)

    def l2(self, params):
        total = self.embeddings.l2(params)
        for blk in self.blocks:
            total = total + blk.l2(params)
        if self.head_dnn is not None:
            return total + self.head_dnn.l2(params)
        return total + self.hparams[HP.MaskL2Reg] * l2_loss(params["masknet_out_w"])
