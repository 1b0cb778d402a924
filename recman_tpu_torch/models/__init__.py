from .afm import AFM
from .autoint import AutoInt
from .base import Model
from .bst import BST
from .dcn import DCN
from .dcn_v2 import GDCN, DCNv2
from .deepfm import DeepFM
from .dien import DIEN
from .din import DIN
from .dlrm import DLRM
from .fibinet import FiBiNET
from .final_mlp import FinalMLP
from .fm import FM
from .fwfm import FwFM
from .masknet import MaskNet
from .nfm import NFM
from .pnn import PNN
from .wide_deep import WideDeep
from .xdeepfm import XDeepFM

MODEL_REGISTRY = {
    m.name: m
    for m in (
        FM, FwFM, DeepFM, WideDeep, NFM, PNN, DCN, DCNv2, DLRM, XDeepFM, AFM,
        DIN, DIEN, BST, AutoInt, FiBiNET, MaskNet, FinalMLP, GDCN,
    )
}


def model_class(name: str):
    """The model class registered under ``name``; a KeyError for any other
    name, as the reference's ``MODEL_REGISTRY[name]`` raises."""
    return MODEL_REGISTRY[name]


__all__ = [
    "AFM", "AutoInt", "BST", "DCN", "DCNv2", "DIEN", "DIN", "DLRM", "DeepFM", "FM", "FiBiNET",
    "FinalMLP", "FwFM", "GDCN", "MODEL_REGISTRY", "MaskNet", "Model", "NFM", "PNN", "WideDeep",
    "XDeepFM", "model_class",
]
