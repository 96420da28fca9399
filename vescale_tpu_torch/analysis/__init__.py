"""Analysis of the port: the coded findings model (``findings.py``)."""

from .findings import CODES, Finding, FindingCode, FindingReport, Severity

__all__ = ["CODES", "Finding", "FindingCode", "FindingReport", "Severity"]
