"""Host-side data helpers and feature extraction of the PyTorch port."""
