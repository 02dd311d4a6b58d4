from .utility import append_axes, torch_gradient, torch_jacobi
from .moments import (moment_tensor, get_default_moment_transform,
                      Transform, D1Q3Transform, D2Q9Lallemand, D2Q9Dellar,
                      D3Q27Hermite, D3Q19DHumieres)

__all__ = ["append_axes", "torch_gradient", "torch_jacobi", "moment_tensor",
           "get_default_moment_transform", "Transform", "D1Q3Transform",
           "D2Q9Lallemand", "D2Q9Dellar", "D3Q27Hermite", "D3Q19DHumieres"]
