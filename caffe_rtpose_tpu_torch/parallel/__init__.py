"""Multi-device inference of the PyTorch port."""
