"""CPM training: data, labels, solvers (the port of ``caffe_rtpose_tpu/training``)."""
