"""Host-side data generators (numpy), shared by both tiers."""
