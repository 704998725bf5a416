"""rl layer of the PyTorch port."""
