"""Models: configuration, building blocks, attention, the dense LM."""
