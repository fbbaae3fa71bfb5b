"""Models (plain PyTorch): the CTR models and the decoder-only LM."""
