from .loader import native_available, partition_int64

__all__ = ["partition_int64", "native_available"]
