"""Host-side utilities of the port."""

from .telemetry import QuantileSketch
