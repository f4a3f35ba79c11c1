"""Pose estimation: model descriptors, preprocessing, limb assembly and the
estimator.  Import submodules directly (``from caffe_rtpose_tpu_torch.pose
import estimator``); this package file loads nothing."""
