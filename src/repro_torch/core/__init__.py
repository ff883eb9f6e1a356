"""Configuration and device selection for the PyTorch port."""
