"""Space-filling-curve codes for point serialization."""

from .encode import ORDERS, encode

__all__ = ["ORDERS", "encode"]
