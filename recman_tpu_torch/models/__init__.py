from .base import Model
from .xdeepfm import XDeepFM

MODEL_REGISTRY = {m.name: m for m in (XDeepFM,)}


def model_class(name: str):
    """The model class registered under the reference's ``name``; any other
    name raises NotImplementedError, since the rest of the reference's zoo
    is not ported yet."""
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md queue 1: the model zoo)")
    return MODEL_REGISTRY[name]


__all__ = ["MODEL_REGISTRY", "Model", "XDeepFM", "model_class"]
