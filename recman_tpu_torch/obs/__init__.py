from .best_model import BestModelFinder
from .tb import TensorBoardLogger

__all__ = ["BestModelFinder", "TensorBoardLogger"]
