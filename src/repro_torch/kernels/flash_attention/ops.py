"""Blocked causal / bidirectional GQA flash attention: kernel wrapper and
plain version.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention`` (the
TPU kernel at ``kernels/flash_attention/kernel.py:84``). The CUDA kernel is
``repro_torch/csrc/flash_attention.cu``; its header says what bounds it on
the H100 and how the design meets that.

Model layout in and out: q (B, Sq, H, dh), k/v (B, Skv, KV, dh). Key j is
visible to query i = q_offset + row iff j < Skv, (not causal or j <= i)
and i - j < window. Block sizes are fixed inside the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch, build

NEG_INF = -2.0e30
GLOBAL_WINDOW = 2 ** 30

launches = 0          # kernel launches since the last reset (main-path proof)


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          q_offset: int = 0):
    """Plain PyTorch version (mirrors ``flash_attention_ref``): the full
    score matrix, softmax and PV in fp32, cast to q's dtype. A row with no
    visible key outputs 0, as the kernel does."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, dh)
    scores = torch.einsum("bikgd,bjkd->bkgij", qf, k.float()) * (dh ** -0.5)
    i = q_offset + torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= (i - j) < window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1) * mask.any(-1, keepdim=True)
    out = torch.einsum("bkgij,bjkd->bikgd", probs, v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0):
    """q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh) -> (B, Sq, H, dh). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    dtype = _launch.check_cuda_inputs("flash_attention", q, k, v)
    B, Sq, H, dh = q.shape
    Bk, Skv, KV, dhk = k.shape
    if Bk != B or dhk != dh or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KV:
        raise ValueError(f"flash_attention: H={H} not divisible by KV={KV}")
    if dh > _launch.MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: dh={dh} > "
                         f"{_launch.MAX_HEAD_DIM} not supported")
    window = GLOBAL_WINDOW if window is None else int(window)
    if window < 1:
        raise ValueError(f"flash_attention: window={window} must be >= 1")
    out = torch.empty_like(q)
    rc = build.load().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, dh, int(causal), window, int(q_offset),
        float(dh) ** -0.5, _launch.vector_ok(dh, q, k, v), dtype,
        _launch.stream_handle(q.device))
    if rc:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    return out
