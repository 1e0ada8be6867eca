"""One-token GQA decode attention: kernel wrapper and plain version.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attention``
(the TPU kernel at ``kernels/decode_attention/kernel.py:74``). The CUDA
kernel is ``repro_torch/csrc/decode_attention.cu``; its header says what
bounds it on the H100 and how the design meets that.

Model layout in and out: q (B, 1, H, dh), cache (B, S_c, KV, dh),
pos_ids (S_c,) int32 with -1 for an empty slot, pos the current position
(an int, or a 0-d int32 tensor on the inputs' device: the kernel reads it
from device memory, as the TPU kernel reads its SMEM scalar, so a captured
CUDA graph serves every position). A slot is visible iff 0 <= pos_id <= pos
and pos - pos_id < window.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _launch, build, tuning

NEG_INF = -2.0e30
GLOBAL_WINDOW = 2 ** 30
TILE_SLOTS = 64       # slots per tile of the Hopper body: the split's unit
CLUSTER_MAX = 8       # splits of one (b, kv group): the blocks of one cluster
HOPPER_MAX_HEAD_DIM = 128
HOPPER_MAX_GROUP = 16

launches = 0          # kernel launches since the last reset (main-path proof)
hopper_launches = 0   # those of them through decode_sm90_kernel


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


def split_count(B: int, KV: int, S: int, sms: int) -> int:
    """Blocks per (b, kv group): about one block per SM, at most
    CLUSTER_MAX (they merge as one thread block cluster), each a whole
    number of the Hopper body's 64-slot tiles. On the H100 the main decode
    shape ran faster at 4 splits (128 blocks) than at 8, and B 1 at 8
    (``tools/ablate_decode.py``). The paged kernel splits its
    S = max_pages · page_size slots by the same rule."""
    want = min(CLUSTER_MAX, max(1, math.ceil(sms / (B * KV))))
    chunk = TILE_SLOTS * max(1, math.ceil(S / (want * TILE_SLOTS)))
    return math.ceil(S / chunk)


def takes_hopper_decode(dtype, dh: int, vec: int, G: int) -> bool:
    """Whether a call runs decode_sm90_kernel (QK^T on the tensor cores, a
    cp.async K/V ring) in place of the fp32-FMA body: bf16, 16-byte aligned
    rows of at most 128 elements, a group of at most 16 heads. The rule of
    ``dispatch_decode`` (``decode_sm90_takes``); shapes alone decide, so
    kernels 1 and 3 pick alike."""
    return dtype == torch.bfloat16 and bool(vec) and dh % 8 == 0 \
        and dh <= HOPPER_MAX_HEAD_DIM and G <= HOPPER_MAX_GROUP


def decode_attention(q, k_cache, v_cache, pos_ids, pos, *, window=None,
                     n_split=None):
    """q: (B, 1, H, dh); k/v_cache: (B, S_c, KV, dh); pos_ids: (S_c,)
    int32; pos: int or 0-d int32 tensor on q's device (``_launch.
    device_position``) -> (B, 1, H, dh). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. n_split: the split
    count (``tuning.split_legal``); None: the tuned table's where it was
    timed at this B · KV, else split_count's."""
    global launches, hopper_launches
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
    pos = _launch.device_position("decode_attention", pos, q.device)
    window = GLOBAL_WINDOW if window is None else int(window)
    n_split = tuning.resolve(
        "decode_attention", S_c, dh, "n_split", n_split,
        split_count(B, KV, S_c, _sm_count(q.device.index)),
        lambda n: tuning.split_legal(n, S_c), at={"blocks": B * KV})
    vec = _launch.vector_ok(dh, q, k_cache, v_cache)
    out = torch.empty_like(q)
    rc = build.load().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_ids.data_ptr(), out.data_ptr(), B, S_c, H, KV, dh, pos.data_ptr(),
        window, float(dh) ** -0.5, n_split, vec, dtype,
        _launch.stream_handle(q.device))
    if rc:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    hopper_launches += takes_hopper_decode(q.dtype, dh, vec, G)
    return out
