"""The native (host C++) streaming GFDN renderer."""

from .tdfdn import native_available, NativeGFDNRenderer

__all__ = ["NativeGFDNRenderer", "native_available"]
