"""How each model family's program objects are built from a configuration
file and the benchmark's weights and data: ``families/<family>.py``."""
