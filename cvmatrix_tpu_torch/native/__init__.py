from .loader import partition_int64

__all__ = ["partition_int64"]
