"""CTR models (plain PyTorch)."""
