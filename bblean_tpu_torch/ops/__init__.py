r"""Device ops of the PyTorch port (packing, iSIM, merge criteria, tile
search)."""
