"""Runtime sanitizers for the port's hot paths (:mod:`.sanitizers`)."""
from repro_torch.analysis.sanitizers import hot_path

__all__ = ["hot_path"]
