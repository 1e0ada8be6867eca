"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
MAX_HEAD_DIM = 256


def check_cuda_inputs(name: str, *tensors: torch.Tensor) -> int:
    """Same CUDA device, one supported dtype, contiguous; returns the
    dtype code the C entry points take."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CPU or CUDA tensors, got {dev}")
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dt} not supported "
                        f"(bfloat16 or float32)")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: all inputs must share device and "
                             f"dtype ({dev}, {dt})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return DTYPE_CODES[dt]


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def vector_ok(dh: int, *tensors: torch.Tensor) -> int:
    """1 when rows of dh elements can be read in 16-byte vectors: whole
    vectors per row and 16-byte aligned bases."""
    return int((dh * tensors[0].element_size()) % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))
