"""parallel layer of the PyTorch port."""
