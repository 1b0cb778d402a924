from .cin import CIN
from .common import ACTIVATIONS, dropout, leaky_relu, resolve_activation
from .dnn import DNN, dnn_combine
from .embedding import EmbeddingLayer, sqrtn_combine
from .linear import LinearLayer
from .packed import PackedEmbeddingLinear
from .prediction import PredictionLayer

__all__ = [
    "ACTIVATIONS",
    "CIN",
    "DNN",
    "EmbeddingLayer",
    "LinearLayer",
    "PackedEmbeddingLinear",
    "PredictionLayer",
    "dnn_combine",
    "dropout",
    "leaky_relu",
    "resolve_activation",
    "sqrtn_combine",
]
