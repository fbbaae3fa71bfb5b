"""The architectures: one module per model family, named by a configuration
file's ``"model"`` key and found by name (``harness/layout.py``)."""
