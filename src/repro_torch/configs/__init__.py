"""Model configurations carried over from the reference package."""
