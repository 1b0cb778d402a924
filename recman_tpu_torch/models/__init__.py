from .afm import AFM
from .base import Model
from .bst import BST
from .dcn import DCN
from .deepfm import DeepFM
from .dien import DIEN
from .din import DIN
from .fm import FM
from .fwfm import FwFM
from .nfm import NFM
from .wide_deep import WideDeep
from .xdeepfm import XDeepFM

MODEL_REGISTRY = {m.name: m for m in (FM, FwFM, DeepFM, WideDeep, NFM, DCN, XDeepFM, AFM, DIN,
                                       BST, DIEN)}


def model_class(name: str):
    """The model class registered under the reference's ``name``; any other
    name raises NotImplementedError, since the rest of the reference's zoo
    is not ported yet."""
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md queue 1: the model zoo)")
    return MODEL_REGISTRY[name]


__all__ = [
    "AFM", "BST", "DCN", "DIEN", "DIN", "DeepFM", "FM", "FwFM", "MODEL_REGISTRY", "Model", "NFM",
    "WideDeep", "XDeepFM", "model_class",
]
