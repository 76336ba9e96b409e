"""The public training API: `Session` on resident tensors."""
from .session import Session, margins

__all__ = ["Session", "margins"]
