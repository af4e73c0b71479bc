from .partitioner import Partitioner
from .cvmatrix import CVMatrix

__all__ = ["CVMatrix", "Partitioner"]
