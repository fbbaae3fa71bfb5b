"""Training steps on one card (the reference's distribution package, cut to one device)."""
