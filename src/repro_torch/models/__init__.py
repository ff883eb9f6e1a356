"""Model code of the PyTorch port (twin of ``repro.models``)."""
