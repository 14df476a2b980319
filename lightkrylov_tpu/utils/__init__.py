"""Utilities: logging, timing, dense linear algebra, options/metadata
(counterpart of ``src/Utilities/``)."""

from . import linalg, logger, options, timer

__all__ = ["linalg", "logger", "options", "timer"]
