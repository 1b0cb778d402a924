from .afm import AFMLayer
from .bi_interaction import BiInteractionPooling
from .cin import CIN
from .common import ACTIVATIONS, dropout, leaky_relu, resolve_activation
from .cross import CrossNet
from .dnn import DNN, dnn_combine
from .embedding import EmbeddingLayer, sqrtn_combine
from .fm import FMLayer, FwFMLayer
from .linear import LinearLayer
from .packed import PackedEmbeddingLinear
from .prediction import PredictionLayer

__all__ = [
    "ACTIVATIONS",
    "AFMLayer",
    "BiInteractionPooling",
    "CIN",
    "CrossNet",
    "DNN",
    "EmbeddingLayer",
    "FMLayer",
    "FwFMLayer",
    "LinearLayer",
    "PackedEmbeddingLinear",
    "PredictionLayer",
    "dnn_combine",
    "dropout",
    "leaky_relu",
    "resolve_activation",
    "sqrtn_combine",
]
