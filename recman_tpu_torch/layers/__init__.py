from .afm import AFMLayer
from .bi_interaction import BiInteractionPooling
from .bst import TransformerEncoderLayer
from .cin import CIN
from .common import ACTIVATIONS, batch_moments, dice, dropout, leaky_relu, resolve_activation
from .cross import CrossNet
from .dien import InterestEvolution
from .din_attention import ASPLayer
from .dnn import DNN, dnn_combine
from .embedding import EmbeddingLayer, sqrtn_combine
from .fm import FMLayer, FwFMLayer
from .linear import LinearLayer
from .masknet import LayerNorm
from .packed import PackedEmbeddingLinear
from .prediction import PredictionLayer

__all__ = [
    "ACTIVATIONS",
    "AFMLayer",
    "ASPLayer",
    "BiInteractionPooling",
    "CIN",
    "CrossNet",
    "DNN",
    "EmbeddingLayer",
    "FMLayer",
    "FwFMLayer",
    "InterestEvolution",
    "LayerNorm",
    "LinearLayer",
    "PackedEmbeddingLinear",
    "PredictionLayer",
    "TransformerEncoderLayer",
    "batch_moments",
    "dice",
    "dnn_combine",
    "dropout",
    "leaky_relu",
    "resolve_activation",
    "sqrtn_combine",
]
