"""Command-line tools (``python -m caffe_rtpose_tpu_torch <tool>``)."""
