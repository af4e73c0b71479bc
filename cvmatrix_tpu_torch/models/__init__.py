from .partitioner import Partitioner
from .cvmatrix import CVMatrix
from .pls import cross_validate_pls

__all__ = ["CVMatrix", "Partitioner", "cross_validate_pls"]
