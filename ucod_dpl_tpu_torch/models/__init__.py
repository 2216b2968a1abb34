"""Models of the PyTorch port: DINO ViT, DBA decoder, checkpoints."""
