"""The conv1 block of the VGG trunk in bf16: the hand-written CUDA kernel
``csrc/conv1_block.cu``, its wrapper and its plain PyTorch version.

    conv1_1 (3->64, 3x3, pad 1) -> ReLU -> conv1_2 (64->64, 3x3, pad 1)
    -> ReLU -> 2x2/2 max pool

:func:`conv1_block` replaces ``caffe_rtpose_tpu/ops/conv1_pallas.py::
_kernel`` (reached through ``conv1_block_pallas``): bf16 in, bf16 out, f32
sums and biases, the conv1_1 activations rounded to bf16 once.  Both
convolutions run on Hopper's tensor cores (``wgmma``, conv1_2's weights in
the swizzled layout :meth:`Conv1Weights.pack` makes); the 31 MB
intermediates per 656x368 canvas never reach device memory.  Bound by the
18.6 GFLOP a canvas (the source note says more).

The kernel is the ``torch.library`` operator ``crt::conv1_block`` (input
and the four packed tensors, one by one), so that ``torch.export`` records
it and a loaded program launches it.  It dispatches on the tensor's device:
the CUDA implementation launches the kernel (or raises: there is no
fallback), the CPU implementation runs the plain version on the weights
unpacked from the pack, which are the bf16-rounded weights the plain
version convolves with.  The fake implementation gives the (B, 64, H/2,
W/2) bf16 ``channels_last`` output.  ``launches`` counts kernel launches
and nothing else.  The plain version, :func:`conv1_block_reference`, is the
CPU path and the tests' reference.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

launches = 0  # kernel launches made by conv1_block in this process
_sms: Dict[int, int] = {}  # device index -> SM count, the grid cap; set up once per device


def _sw128(m: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of (..., rows, 64) bf16 K-major tiles: row n's
    16-byte chunk c moves to chunk c ^ (n % 8), the layout a wgmma
    descriptor with swizzle mode 1 reads.  Its own inverse."""
    n = torch.arange(m.shape[-2], device=m.device)[:, None]
    col = torch.arange(64, device=m.device)[None, :]
    idx = ((col // 8) ^ (n % 8)) * 8 + col % 8
    return m.gather(-1, idx.expand(m.shape))


@dataclass(frozen=True)
class Conv1Weights:
    """The block's parameters, packed once for the kernel.

    ``w1``/``w2``: OIHW f32 as the net stores them, ``b1``/``b2`` f32.
    ``w1_p``: (64, 64) bf16, conv1_1 as a K-major tile: row c_out, columns
    K = (ky, kx, c) zero-padded from 27 to 64 (the kernel reads 32), in the
    128-byte swizzle; ``w2_p``: (9, 64, 64) bf16, per tap (ky, kx) the
    (c_out, c_in) K-major tile in the same swizzle.  :meth:`w1_matrix` and
    :meth:`w2_matrix` unpack them."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w1_p: torch.Tensor
    w2_p: torch.Tensor

    @classmethod
    def pack(cls, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor) -> "Conv1Weights":
        if tuple(w1.shape) != (64, 3, 3, 3) or tuple(w2.shape) != (64, 64, 3, 3):
            raise ValueError(f"conv1 block: weights {tuple(w1.shape)}, {tuple(w2.shape)}; "
                             "expected (64, 3, 3, 3) and (64, 64, 3, 3)")
        f32, bf16 = torch.float32, torch.bfloat16
        w1, b1, w2, b2 = (t.detach().to(f32) for t in (w1, b1, w2, b2))
        k1 = torch.zeros((64, 64), dtype=bf16, device=w1.device)
        k1[:, :27] = w1.to(bf16).permute(0, 2, 3, 1).reshape(64, 27)
        k2 = w2.to(bf16).permute(2, 3, 0, 1).reshape(9, 64, 64)
        return cls(w1, b1.contiguous(), w2, b2.contiguous(), _sw128(k1).contiguous(),
                   _sw128(k2).contiguous())

    def w1_matrix(self) -> torch.Tensor:
        """(32, 64) f32: conv1_1's K-padded GEMM operand, rows (ky, kx, c)
        then 5 zero rows, columns c_out."""
        return _sw128(self.w1_p)[:, :32].t().float()

    def w2_matrix(self) -> torch.Tensor:
        """(576, 64) bf16: conv1_2's GEMM operand, rows (ky, kx, c_in)."""
        return _sw128(self.w2_p).transpose(1, 2).reshape(576, 64)


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv1_block: expected bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"conv1_block: expected (B, 3, H, W), got {tuple(x.shape)}")
    h, w = x.shape[2:]
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"conv1_block: H and W must be even, got {h}x{w}")


PACKED = ("w1_p", "b1", "w2_p", "b2")  # the kernel's operands, in its argument order


def _chain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
           b2: torch.Tensor) -> torch.Tensor:
    """The plain version on f32 OIHW weights that hold bf16 values."""
    f32, bf16 = torch.float32, torch.bfloat16
    x = x.to(f32).contiguous(memory_format=torch.channels_last)
    h1 = F.conv2d(x, w1, b1, padding=1).relu_().to(bf16)
    h2 = F.conv2d(h1.to(f32), w2, b2, padding=1).relu_()
    return F.max_pool2d(h2, 2, 2).to(bf16).contiguous(memory_format=torch.channels_last)


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
    return _chain(x, cw.w1.to(bf16).to(f32), cw.b1, cw.w2.to(bf16).to(f32), cw.b2)


@torch.library.custom_op("crt::conv1_block", mutates_args=(), device_types="cuda")
def _conv1_op(x: torch.Tensor, w1_p: torch.Tensor, b1: torch.Tensor, w2_p: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """K4 on (B, 3, H, W) bf16 -> (B, 64, H/2, W/2) bf16 channels_last, one
    launch."""
    global launches
    for t in (w1_p, b1, w2_p, b2):
        if t.device != x.device:
            raise ValueError(f"conv1_block: weights on {t.device}, input on {x.device}")
    from .. import _build

    lib = _build.load_kernels()
    b, _, h, w = x.shape
    out = torch.empty((b, 64, h // 2, w // 2), dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    st = x.stride()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        if dev not in _sms:
            err = lib.crt_conv1_prepare()
            if err != 0:
                raise RuntimeError(f"conv1_block: shared-memory attribute refused: "
                                   f"{lib.crt_cuda_error_string(err).decode()} ({err})")
            _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.crt_conv1_block(ptr(x), st[0], st[1], st[2], st[3], b, h, w,
                                  ptr(w1_p), ptr(b1), ptr(w2_p), ptr(b2),
                                  ptr(out), _sms[dev], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"conv1_block kernel launch failed: {lib.crt_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return out


@_conv1_op.register_kernel("cpu")
def _conv1_cpu(x, w1_p, b1, w2_p, b2):
    f32 = torch.float32
    w1 = _sw128(w1_p)[:, :27].reshape(64, 3, 3, 3).permute(0, 3, 1, 2).to(f32)
    w2 = _sw128(w2_p).reshape(3, 3, 64, 64).permute(2, 3, 0, 1).to(f32)
    return _chain(x, w1, b1, w2, b2)


@_conv1_op.register_fake
def _conv1_fake(x, w1_p, b1, w2_p, b2):
    b, _, h, w = x.shape
    return torch.empty((b, 64, h // 2, w // 2), dtype=torch.bfloat16, device=x.device,
                       memory_format=torch.channels_last)


def conv1_block(x: torch.Tensor, cw: Conv1Weights) -> torch.Tensor:
    """(B, 3, H, W) bf16, any strides (the net's channels_last blob), H and
    W even -> (B, 64, H/2, W/2) bf16 channels_last.  Equal to
    :func:`conv1_block_reference` up to f32 summation order: within 2 bf16
    ulps (one from the order, one where the sums straddle a rounding
    boundary), as the Pallas kernel is to the XLA chain."""
    return conv1_block_packed(x, *(getattr(cw, k) for k in PACKED))


def conv1_block_packed(x: torch.Tensor, w1_p: torch.Tensor, b1: torch.Tensor,
                       w2_p: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """:func:`conv1_block` on the four packed tensors of a
    :class:`Conv1Weights` (:data:`PACKED`): the operator
    ``crt::conv1_block``."""
    _check(x)
    return torch.ops.crt.conv1_block(x, w1_p, b1, w2_p, b2)
