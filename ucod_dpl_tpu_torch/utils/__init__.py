"""Host utilities of the PyTorch port: its own copies of what it needs from
the JAX package's ``utils`` (the port imports nothing of that package)."""
