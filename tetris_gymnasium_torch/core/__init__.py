"""core layer of the PyTorch port."""
