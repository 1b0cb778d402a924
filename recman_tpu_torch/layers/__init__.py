from ..utils import split_rng
from .afm import AFMLayer
from .autoint import InteractingLayer
from .batchnorm import BatchNormalization
from .bi_interaction import BiInteractionPooling
from .bst import TransformerEncoderLayer
from .cin import CIN
from .common import (
    ACTIVATIONS,
    batch_moments,
    dice,
    dropout,
    leaky_relu,
    resolve_activation,
)
from .cross import CrossNet
from .cross_v2 import CrossNetV2
from .dien import InterestEvolution
from .din_attention import ASPLayer
from .dnn import DNN, dnn_combine
from .embedding import EmbeddingLayer, sqrtn_combine
from .final_mlp import FeatureSelectionGate, InteractionAggregation, MLPBlock
from .fm import FMLayer, FwFMLayer
from .linear import LinearLayer, SparseLinearLayer
from .masknet import LayerNorm, MaskBlock
from .packed import PackedEmbeddingLinear
from .prediction import PredictionLayer
from .product import ProductLayer
from .senet import BilinearInteraction, SENETLayer

__all__ = [
    "ACTIVATIONS",
    "AFMLayer",
    "ASPLayer",
    "BatchNormalization",
    "BiInteractionPooling",
    "BilinearInteraction",
    "CIN",
    "CrossNet",
    "CrossNetV2",
    "DNN",
    "EmbeddingLayer",
    "FMLayer",
    "FeatureSelectionGate",
    "FwFMLayer",
    "InteractingLayer",
    "InteractionAggregation",
    "InterestEvolution",
    "LayerNorm",
    "LinearLayer",
    "MLPBlock",
    "MaskBlock",
    "PackedEmbeddingLinear",
    "PredictionLayer",
    "ProductLayer",
    "SENETLayer",
    "SparseLinearLayer",
    "TransformerEncoderLayer",
    "batch_moments",
    "dice",
    "dnn_combine",
    "dropout",
    "leaky_relu",
    "resolve_activation",
    "split_rng",
    "sqrtn_combine",
]
