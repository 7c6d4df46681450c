r"""The PyTorch port's batch engine."""
