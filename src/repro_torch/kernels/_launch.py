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


def device_position(name: str, pos, device: torch.device) -> torch.Tensor:
    """The position a decode kernel reads from device memory: a 0-d int32
    tensor on `device` as it is, or a host int written into a new one. A
    host int would be frozen into a CUDA graph under capture, so it is
    refused while the current stream captures."""
    if isinstance(pos, torch.Tensor):
        if pos.shape != () or pos.dtype != torch.int32 or pos.device != device:
            raise ValueError(f"{name}: pos must be a 0-d int32 tensor on "
                             f"{device}, not {tuple(pos.shape)} {pos.dtype} "
                             f"on {pos.device}")
        return pos
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name}: a host int position would be frozen into "
                           "the graph being captured; pass a 0-d int32 "
                           "device tensor")
    return torch.full((), pos, dtype=torch.int32, device=device)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def vector_ok(dh: int, *tensors: torch.Tensor) -> int:
    """1 when rows of dh elements can be read in 16-byte vectors: whole
    vectors per row and 16-byte aligned bases."""
    return int((dh * tensors[0].element_size()) % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


HOPPER_MAX_HEAD_DIM = 128
HOPPER_ROWS = 128     # query rows of one work item of the Hopper mainloop


def hopper_mainloop(dh: int, vec: int, G: int) -> bool:
    """The shapes the Hopper mainloop of ``csrc/attention_sm90.cuh`` takes
    (its ``takes``): 16-byte aligned bf16 rows of at most 128 elements, and
    a GQA group that fits one work item. The flash wrapper adds bf16, the
    multi-query wrappers an unsplit call."""
    return bool(vec) and dh % 8 == 0 and dh <= HOPPER_MAX_HEAD_DIM \
        and G <= HOPPER_ROWS
