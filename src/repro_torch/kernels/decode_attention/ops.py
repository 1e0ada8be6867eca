"""One-token GQA decode attention: kernel wrapper and plain version.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attention``
(the TPU kernel at ``kernels/decode_attention/kernel.py:74``). The CUDA
kernel is ``repro_torch/csrc/decode_attention.cu``; its header says what
bounds it on the H100 and how the design meets that.

Model layout in and out: q (B, 1, H, dh), cache (B, S_c, KV, dh),
pos_ids (S_c,) int32 with -1 for an empty slot, pos the current position.
A slot is visible iff 0 <= pos_id <= pos and pos - pos_id < window.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _launch, build

NEG_INF = -2.0e30
GLOBAL_WINDOW = 2 ** 30
TILE_SLOTS = 32       # slots per shared-memory tile in the kernel

launches = 0          # kernel launches since the last reset (main-path proof)


def decode_attention_plain(q, k_cache, v_cache, pos_ids, pos, *, window=None):
    """Plain PyTorch version (mirrors ``decode_attention_ref``): fp32
    scores, softmax, probabilities rounded to the cache dtype before the PV
    product. A query with no visible slot outputs 0, as the kernel does."""
    B, _, H, dh = q.shape
    S_c, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) \
        * (dh ** -0.5)
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    if window is not None:
        valid &= (pos - pos_ids) < window
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype) * valid.any()
    out = torch.einsum("bkgs,bskd->bkgd", probs.float(), v_cache.float())
    return out.to(v_cache.dtype).reshape(B, 1, H, dh)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _n_split(B: int, KV: int, S_c: int, device) -> int:
    """Enough S_c splits for about four blocks per SM, each a whole number
    of the kernel's 32-slot tiles."""
    want = max(1, math.ceil(4 * _sm_count(device.index) / (B * KV)))
    chunk = TILE_SLOTS * max(1, math.ceil(S_c / (want * TILE_SLOTS)))
    return math.ceil(S_c / chunk)


def decode_attention(q, k_cache, v_cache, pos_ids, pos, *, window=None):
    """q: (B, 1, H, dh); k/v_cache: (B, S_c, KV, dh); pos_ids: (S_c,)
    int32; pos: int -> (B, 1, H, dh). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos_ids, pos,
                                      window=window)
    dtype = _launch.check_cuda_inputs("decode_attention", q, k_cache, v_cache)
    B, one, H, dh = q.shape
    Bc, S_c, KV, dhc = k_cache.shape
    if one != 1 or Bc != B or dhc != dh or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if H % KV:
        raise ValueError(f"decode_attention: H={H} not divisible by KV={KV}")
    G = H // KV
    if dh > _launch.MAX_HEAD_DIM or not (G <= 8 or (G <= 16 and dh <= 128)):
        raise ValueError(f"decode_attention: G={G}, dh={dh} not supported "
                         f"(dh <= 256 with G <= 8, or dh <= 128 with G <= 16)")
    if pos_ids.shape != (S_c,) or pos_ids.dtype != torch.int32 \
            or pos_ids.device != q.device or not pos_ids.is_contiguous():
        raise ValueError("decode_attention: pos_ids must be a contiguous "
                         f"({S_c},) int32 tensor on {q.device}")
    window = GLOBAL_WINDOW if window is None else int(window)
    n_split = _n_split(B, KV, S_c, q.device)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty((B, KV, n_split, G, dh), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, KV, n_split, G, 2), dtype=torch.float32,
                              device=q.device)
    rc = build.load().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_ids.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        B, S_c, H, KV, dh, int(pos), window, float(dh) ** -0.5, n_split,
        _launch.vector_ok(dh, k_cache, v_cache), dtype,
        _launch.stream_handle(q.device))
    if rc:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    return out
