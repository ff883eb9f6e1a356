"""Launchers of the PyTorch port (twin of ``repro.launch``)."""
