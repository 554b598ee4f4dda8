"""Command-line apps of the PyTorch port."""
