"""The harness shared by every cell: manifest loading, seeded device
tensors, the measured window, the trace and its reduction."""
