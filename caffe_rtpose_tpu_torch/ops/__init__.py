"""Tensor ops of the PyTorch port: convolution and pooling, the bicubic
ImResize, peak NMS and the hand-written peak-mask kernel's wrapper."""
