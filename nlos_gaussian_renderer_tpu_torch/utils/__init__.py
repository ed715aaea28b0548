"""Host-side utilities: scene initialization and space carving,
checkpoints, geometry export, profiling."""
