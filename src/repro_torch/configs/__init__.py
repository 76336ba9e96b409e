"""Architecture registry of the port: the LM configurations it serves."""
from .base import ArchConfig, get_config, get_smoke, list_archs, register

__all__ = ["ArchConfig", "get_config", "get_smoke", "list_archs",
           "register"]
