"""The port's numpy metrics."""

from .onset_f1 import onset_f1

__all__ = ["onset_f1"]
