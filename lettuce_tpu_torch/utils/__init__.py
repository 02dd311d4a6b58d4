from .utility import torch_gradient

__all__ = ["torch_gradient"]
