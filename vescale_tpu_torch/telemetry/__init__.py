"""Telemetry of the port: an in-process registry the serve path writes to."""

from .registry import Histogram, Registry, prometheus_text

__all__ = ["Histogram", "Registry", "prometheus_text"]
