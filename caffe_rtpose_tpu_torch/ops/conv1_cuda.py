"""The conv1 block of the VGG trunk in bf16: the hand-written CUDA kernel
``csrc/conv1_block.cu``, its wrapper and its plain PyTorch version.

    conv1_1 (3->64, 3x3, pad 1) -> ReLU -> conv1_2 (64->64, 3x3, pad 1)
    -> ReLU -> 2x2/2 max pool

:func:`conv1_block` replaces ``caffe_rtpose_tpu/ops/conv1_pallas.py::
_kernel`` (reached through ``conv1_block_pallas``): bf16 in, bf16 out, f32
sums and biases, the conv1_1 activations rounded to bf16 once.  conv1_2 runs
on the tensor cores; the 31 MB intermediates per 656x368 canvas never reach
device memory.  Bound by conv1_2's 17.8 GFLOP a canvas (the source note
says more).

The wrapper launches the kernel for a CUDA tensor (or raises: there is no
fallback) and runs the plain version for a CPU tensor.  ``launches`` counts
kernel launches and nothing else.  The plain version,
:func:`conv1_block_reference`, is the CPU path and the tests' reference.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

launches = 0  # kernel launches made by conv1_block in this process


@dataclass(frozen=True)
class Conv1Weights:
    """The block's parameters, packed once for the kernel.

    ``w1``/``w2``: OIHW f32 as the net stores them, ``b1``/``b2`` f32.
    ``w1_k``: (27, 64) f32, rows (ky, kx, c), values rounded to bf16;
    ``w2_k``: (576, 64) bf16, rows (ky, kx, c_in)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w1_k: torch.Tensor
    w2_k: torch.Tensor

    @classmethod
    def pack(cls, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor) -> "Conv1Weights":
        if tuple(w1.shape) != (64, 3, 3, 3) or tuple(w2.shape) != (64, 64, 3, 3):
            raise ValueError(f"conv1 block: weights {tuple(w1.shape)}, {tuple(w2.shape)}; "
                             "expected (64, 3, 3, 3) and (64, 64, 3, 3)")
        f32, bf16 = torch.float32, torch.bfloat16
        w1, b1, w2, b2 = (t.detach().to(f32) for t in (w1, b1, w2, b2))
        w1_k = w1.to(bf16).to(f32).permute(2, 3, 1, 0).reshape(27, 64).contiguous()
        w2_k = w2.to(bf16).permute(2, 3, 1, 0).reshape(576, 64).contiguous()
        return cls(w1, b1.contiguous(), w2, b2.contiguous(), w1_k, w2_k)


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv1_block: expected bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"conv1_block: expected (B, 3, H, W), got {tuple(x.shape)}")
    h, w = x.shape[2:]
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"conv1_block: H and W must be even, got {h}x{w}")


def conv1_block_reference(x: torch.Tensor, cw: Conv1Weights) -> torch.Tensor:
    """Plain PyTorch version, with the JAX chain's rounding points: f32
    convolutions of bf16-valued operands (each product exact in f32), f32
    biases, one rounding to bf16 per convolution.  Equal to the JAX bf16
    chain up to f32 summation order.  On the card that needs TF32 off and
    channels_last operands: cuDNN then sums the exact products, where for
    NCHW f32 it may pick an algorithm that is a few bf16 ulps off (seen at
    656x368).  (B, 3, H, W) bf16 -> (B, 64, H/2, W/2) bf16, channels_last."""
    _check(x)
    f32, bf16 = torch.float32, torch.bfloat16
    x = x.to(f32).contiguous(memory_format=torch.channels_last)
    h1 = F.conv2d(x, cw.w1.to(bf16).to(f32), cw.b1, padding=1).relu_().to(bf16)
    h2 = F.conv2d(h1.to(f32), cw.w2.to(bf16).to(f32), cw.b2, padding=1).relu_()
    return F.max_pool2d(h2, 2, 2).to(bf16).contiguous(memory_format=torch.channels_last)


def conv1_block(x: torch.Tensor, cw: Conv1Weights) -> torch.Tensor:
    """(B, 3, H, W) bf16, any strides (the net's channels_last blob), H and
    W even -> (B, 64, H/2, W/2) bf16 channels_last.  Equal to
    :func:`conv1_block_reference` up to f32 summation order: within 2 bf16
    ulps (one from the order, one where the sums straddle a rounding
    boundary), as the Pallas kernel is to the XLA chain."""
    global launches
    _check(x)
    if x.device.type == "cpu":
        return conv1_block_reference(x, cw)
    if x.device.type != "cuda":
        raise ValueError(f"conv1_block: unsupported device {x.device}")
    for t in (cw.w1_k, cw.b1, cw.w2_k, cw.b2):
        if t.device != x.device:
            raise ValueError(f"conv1_block: weights on {t.device}, input on {x.device}")
    from .. import _build

    lib = _build.load_kernels()
    b, _, h, w = x.shape
    out = torch.empty((b, 64, h // 2, w // 2), dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    st = x.stride()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.crt_conv1_block(ptr(x), st[0], st[1], st[2], st[3], b, h, w,
                                  ptr(cw.w1_k), ptr(cw.b1), ptr(cw.w2_k), ptr(cw.b2),
                                  ptr(out), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"conv1_block kernel launch failed: {lib.crt_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return out
