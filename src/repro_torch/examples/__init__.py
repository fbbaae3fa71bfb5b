"""The platform's entry-point examples, run with ``python -m``."""
