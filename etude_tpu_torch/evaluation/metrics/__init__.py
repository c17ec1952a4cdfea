"""The port's metrics (JAX counterpart: etude_tpu/evaluation/metrics), in
numpy; WPD reads the aligner's warping path."""

from .base_metric import get_onsets_from_file
from .ipe import IPECalculator
from .onset_f1 import onset_f1
from .rgc import RGCCalculator
from .wpd import WPDCalculator

__all__ = ["WPDCalculator", "RGCCalculator", "IPECalculator", "get_onsets_from_file",
           "onset_f1"]
