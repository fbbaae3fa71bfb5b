"""Atomic, async-capable checkpointing (the reference's manifest format)."""
