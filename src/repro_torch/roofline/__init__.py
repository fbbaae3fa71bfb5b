"""Roofline analysis of the port's programs (:mod:`.op_analysis`, the twin
of the reference's ``roofline/hlo_analysis.py``)."""
