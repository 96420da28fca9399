"""Input pipeline of the port: the native token loader."""

from .loader import TokenDataLoader, build_native

__all__ = ["TokenDataLoader", "build_native"]
