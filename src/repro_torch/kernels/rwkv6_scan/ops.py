"""RWKV6 WKV recurrence: kernel wrapper and plain version.

Counterpart of ``repro.kernels.rwkv6_scan.ops.wkv`` (the TPU kernel at
``kernels/rwkv6_scan/kernel.py:80``). The CUDA kernel is
``repro_torch/csrc/wkv_scan.cu``; its header says what bounds it on the
H100 and how the design meets that.

Model layout: r, k, v (B, S, H, dh), w (B, S, H, dh) fp32 decay in (0, 1),
u (H, dh), state (B, H, dh, dh) fp32. Per step t:
``a = k_tᵀ v_t; o_t = r_t (S + u ⊙ a); S ← diag(w_t) S + a`` (the decay
scales the state's k index). Unlike the TPU wrapper, nothing is moved to
(B, H, S, dh) or padded: the kernel reads the model layout.

The kernel has two bodies (``takes_chunked``): bf16 calls of at least
CHUNK_MIN_STEPS steps run the chunked, matrix-form scan on the tensor
cores (``csrc/scan_chunked.cuh``), whose arithmetic ``wkv_chunked_plain``
models; every other call (decode steps, short calls, fp32 inputs) runs the
sequential body, whose arithmetic ``wkv_plain`` models.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch, build

HEAD_DIMS = (32, 64, 128)   # the kernel's compiled column counts
CHUNK_MIN_STEPS = 128       # the chunked body from this many steps (bf16)
SUB = 16                    # steps of a sub-chunk (one mma tile)

launches = 0          # kernel launches since the last reset (main-path proof)
chunked_launches = 0  # ... of them on the chunked body


def takes_chunked(S: int, dtype: torch.dtype, dh: int) -> bool:
    """Whether a call runs the chunked body (csrc/wkv_scan.cu's
    wkv_takes_chunked): bf16 inputs of at least CHUNK_MIN_STEPS steps."""
    return dtype == torch.bfloat16 and S >= CHUNK_MIN_STEPS and dh in HEAD_DIMS


def chunk_len(dh: int) -> int:
    """Steps per chunk of the chunked body (WkvChunkGeom::L): the chunk
    grid starts at a call's first step."""
    return 32 if dh == 128 else 64


def split3(x):
    """x (fp32) as the three bf16 terms hi + mid + lo the chunked bodies
    feed the tensor cores (x to 2^-26), each returned as fp32."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def mm_3e(a, b):
    """a·b with a as three terms and b exact in bf16 (three products)."""
    return sum(t @ b for t in split3(a))


def mm_33(a, b):
    """a·b with both as three terms: the six products of order up to
    2^-16 (hh, hm, mh, hl, mm, lh)."""
    (ah, am, al), (bh, bm, bl) = split3(a), split3(b)
    return ah @ bh + ah @ bm + am @ bh + ah @ bl + am @ bm + al @ bh


def wkv_plain(r, k, v, w, u, state):
    """Plain PyTorch version (mirrors ``repro.models.ssm.wkv_scan_ref``): a
    time loop in fp32. Returns (out (B, S, H, dh) fp32, final state); the
    state passed in is not modified."""
    rf, kf, vf = r.float(), k.float(), v.float()
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        a = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (B, H, dh, dh)
        outs.append(torch.einsum("bhk,bhkd->bhd", rf[:, t], state + uf * a))
        state = w[:, t, :, :, None] * state + a
    return torch.stack(outs, 1), state


def wkv_chunked_plain(r, k, v, w, u, state):
    """Plain PyTorch model of the chunked body's arithmetic (tests and
    tools only): chunks of chunk_len(dh) steps from the first, sub-chunks
    of SUB steps, running products of the decays (no ratios, no logs), the
    three-term bf16 operands of the tensor-core products (emulated with casts,
    fp32 sums), the diagonal blocks' running products, and the recurrence
    over chunk states S <- decay ⊙ S + dS in chunk order. Same arguments
    and returns as wkv_plain."""
    B, S, H, dh = r.shape
    L = chunk_len(dh)
    ns, n = L // SUB, -(-S // L)
    pad = n * L - S

    def blocks(t, fill):       # (B, S, H, dh) -> (B, H, n, ns, SUB, dh)
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_full((B, pad, H, dh), fill)], 1)
        return t.reshape(B, n, ns, SUB, H, dh).permute(0, 4, 1, 2, 3, 5)
    rb, kb, vb, wb = blocks(r, 0.), blocks(k, 0.), blocks(v, 0.), blocks(w, 1.)
    one = torch.ones_like(wb[..., :1, :])
    pre = torch.cumprod(torch.cat([one, wb[..., :-1, :]], -2), -2)
    suf = torch.cumprod(torch.cat([one, wb.flip(-2)[..., :-1, :]], -2), -2).flip(-2)
    dsub = pre[..., -1, :] * wb[..., -1, :]                 # (B, H, n, ns, dh)
    q, kw = rb * pre, kb * suf
    # diagonal blocks: D[t, s] = Σ_i r_t k_s Π_{s<j<t} w_j (s < t), and
    # Σ_i r_t u k_t on the diagonal
    D = rb.new_zeros(rb.shape[:-1] + (SUB,))
    ar = torch.arange(SUB, device=rb.device)
    D[..., ar, ar] = (rb * u.float()[None, :, None, None, None, :] * kb).sum(-1)
    p = kb.clone()
    for d in range(1, SUB):
        D[..., ar[d:], ar[:SUB - d]] = (rb[..., d:, :] * p[..., :SUB - d, :]).sum(-1)
        p[..., :SUB - d, :] = p[..., :SUB - d, :] * wb[..., d:, :]
    dS_T = mm_3e(kw.transpose(-1, -2), vb)                    # (B, H, n, ns, dh, dh)
    dS, dch = dS_T[:, :, :, 0], dsub[:, :, :, 0]
    for T in range(1, ns):
        dS = dsub[:, :, :, T, :, None] * dS + dS_T[:, :, :, T]
        dch = dch * dsub[:, :, :, T]
    starts, Sc = [], state
    for c in range(n):
        starts.append(Sc)
        Sc = dch[:, :, c, :, None] * Sc + dS[:, :, c]
    S_T, outs = torch.stack(starts, 2), []
    for T in range(ns):
        outs.append(mm_33(q[:, :, :, T], S_T) + mm_3e(D[:, :, :, T], vb[:, :, :, T]))
        S_T = dsub[:, :, :, T, :, None] * S_T + dS_T[:, :, :, T]
    out = torch.stack(outs, 3).permute(0, 2, 3, 4, 1, 5).reshape(B, n * L, H, dh)
    return out[:, :S].contiguous(), Sc


def wkv(r, k, v, w, u, state):
    """r, k, v: (B, S, H, dh) bf16 or fp32; w: (B, S, H, dh) fp32; u:
    (H, dh) of r's dtype; state: (B, H, dh, dh) fp32, read as the initial
    state and overwritten IN PLACE with the final one. Returns out
    (B, S, H, dh) fp32. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global launches, chunked_launches
    if r.device.type == "cpu":
        out, new = wkv_plain(r, k, v, w, u, state)
        state.copy_(new)
        return out
    dtype = _launch.check_cuda_inputs("wkv", r, k, v, u)
    B, S, H, dh = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (H, dh) or state.shape != (B, H, dh, dh):
        raise ValueError(f"wkv: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, state {tuple(state.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"wkv: dh={dh} not supported (one of {HEAD_DIMS})")
    for name, t in (("w", w), ("state", state)):
        if t.dtype != torch.float32 or t.device != r.device \
                or not t.is_contiguous():
            raise ValueError(f"wkv: {name} must be a contiguous float32 "
                             f"tensor on {r.device}")
    chunked = takes_chunked(S, r.dtype, dh)
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    scratch = None
    if chunked:
        if any(t.data_ptr() % 16 for t in (r, k, v, w, state)):
            raise ValueError("wkv: the chunked body needs 16-byte aligned r, k, "
                             "v, w and state")
        # the chunks' exchange buffer: a slot of dS and decays per chunk
        # (inside a CUDA graph, memory of the graph's pool: the kernel
        # writes every slot before a cluster barrier and reads them after
        # it, in one launch, so no call reads another's)
        scratch = torch.empty(B * H * -(-S // chunk_len(dh)) * (dh * dh + dh),
                              dtype=torch.float32, device=r.device)
    rc = build.load().repro_wkv_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if chunked else None, B, S, H, dh, dtype,
        _launch.stream_handle(r.device))
    if rc:
        raise RuntimeError(f"wkv kernel launch failed: CUDA error {rc}")
    launches += 1
    chunked_launches += chunked
    return out
