"""components layer of the PyTorch port."""
