"""Mamba selective scan (Hymba's SSM heads): kernel wrapper and plain
version.

Counterpart of ``repro.kernels.ssm_scan.ops.ssm_scan`` (the TPU kernel at
``kernels/ssm_scan/kernel.py:80``). The CUDA kernel is
``repro_torch/csrc/ssm_scan.cu``; its header says what bounds it on the
H100 and how the design meets that.

Model layout: x (B, S, H, dh), dt (B, S, H) fp32, B_in / C_in (B, S, N)
shared by the heads of a batch row, A (H,) fp32 negative, state
(B, H, N, dh) fp32. Per step t: ``h ← exp(A·dt_t) h + (dt_t · B_t) ⊗ x_t;
y_t = C_t · h``. Unlike the TPU wrapper, nothing is moved to (B, H, S, dh)
or padded: the kernel reads the model layout.

The kernel has two bodies (``takes_chunked``): bf16 calls of at least
CHUNK_MIN_STEPS steps run the chunked (SSD, matrix-form) scan on the
tensor cores (``csrc/scan_chunked.cuh``), whose arithmetic
``ssm_scan_chunked_plain`` models; every other call (decode steps, short
calls, fp32 inputs) runs the sequential body, whose arithmetic
``ssm_scan_plain`` models.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch, build
from repro_torch.kernels.rwkv6_scan.ops import CHUNK_MIN_STEPS, SUB, mm_3e, split3

HEAD_DIMS = (32, 64, 128)   # the kernel's compiled column counts
MAX_STATE = 64              # largest N the kernel's registers hold
CHUNK = 64                  # steps per chunk of the chunked body

launches = 0          # kernel launches since the last reset (main-path proof)
chunked_launches = 0  # ... of them on the chunked body


def takes_chunked(S: int, dtype: torch.dtype, dh: int, N: int) -> bool:
    """Whether a call runs the chunked body (csrc/ssm_scan.cu's
    ssm_takes_chunked): bf16 inputs of at least CHUNK_MIN_STEPS steps."""
    return dtype == torch.bfloat16 and S >= CHUNK_MIN_STEPS \
        and dh in HEAD_DIMS and 1 <= N <= MAX_STATE


def ssm_scan_plain(x, dt, B_in, C_in, A, state):
    """Plain PyTorch version (mirrors ``repro.models.ssm.ssm_scan_ref``): a
    time loop in fp32. Returns (y (B, S, H, dh) fp32, final state); the
    state passed in is not modified."""
    decay = torch.exp(A[None, None, :, None] * dt[..., None])    # (B, S, H, 1)
    bf, cf = B_in.float(), C_in.float()
    ys = []
    for t in range(x.shape[1]):
        dbx = (dt[:, t, :, None, None] * bf[:, t, None, :, None]
               * x[:, t, :, None, :].float())                  # (B, H, N, dh)
        state = decay[:, t, :, :, None] * state + dbx
        ys.append(torch.einsum("bn,bhnd->bhd", cf[:, t], state))
    return torch.stack(ys, 1), state


def ssm_scan_chunked_plain(x, dt, B_in, C_in, A, state):
    """Plain PyTorch model of the chunked body's arithmetic (tests and
    tools only): chunks of CHUNK steps from the first, the decays' products
    F(s, t) = Π_{s<j<=t} exp(A dt_j) from running products over 16-step
    blocks (no ratios), C·Bᵀ exact, the three-term bf16 operands of the
    tensor-core products (emulated with casts, fp32 sums), and the
    recurrence over chunk states h <- decay·h + dh in chunk order. Same
    arguments and returns as ssm_scan_plain."""
    Bb, S, H, dh = x.shape
    N, L, nb = B_in.shape[-1], CHUNK, CHUNK // SUB
    n = -(-S // L)
    pad = n * L - S
    xf, dtf, bf, cf = x.float(), dt.float(), B_in.float(), C_in.float()
    if pad:
        xf = torch.cat([xf, xf.new_zeros((Bb, pad, H, dh))], 1)
        dtf = torch.cat([dtf, dtf.new_zeros((Bb, pad, H))], 1)
        bf = torch.cat([bf, bf.new_zeros((Bb, pad, N))], 1)
        cf = torch.cat([cf, cf.new_zeros((Bb, pad, N))], 1)
    xb = xf.reshape(Bb, n, L, H, dh).permute(0, 3, 1, 2, 4)     # (B, H, n, L, dh)
    dtb = dtf.reshape(Bb, n, L, H).permute(0, 3, 1, 2)          # (B, H, n, L)
    bb, cb = bf.reshape(Bb, n, L, N), cf.reshape(Bb, n, L, N)
    a = torch.exp(A[None, :, None, None] * dtb)                 # 1 on padding
    ab = a.reshape(Bb, H, n, nb, SUB)
    preb = torch.cumprod(ab, -1)                                # inclusive
    one = torch.ones_like(ab[..., :1])
    sufb = torch.cumprod(torch.cat([one, ab.flip(-1)[..., :-1]], -1), -1).flip(-1)
    blk = preb[..., -1]                                         # (B, H, n, nb)
    pre, suf = preb.clone(), sufb.clone()
    for q in range(nb):
        for qq in range(q - 1, -1, -1):
            pre[..., q, :] = pre[..., q, :] * blk[..., qq, None]
        for qq in range(q + 1, nb):
            suf[..., q, :] = suf[..., q, :] * blk[..., qq, None]
    pre, suf = pre.reshape(Bb, H, n, L), suf.reshape(Bb, H, n, L)
    dch = blk[..., 0]
    for qq in range(1, nb):
        dch = dch * blk[..., qq]
    # F[t, s] for s <= t: a running product within a block, else
    # sufb[s]·(blocks between)·preb[t]
    F = a.new_zeros(a.shape + (L,))
    for qs in range(nb):
        for qt in range(qs, nb):
            if qs == qt:
                for s in range(SUB):
                    f = torch.ones_like(a[..., 0])
                    for t in range(s, SUB):
                        if t > s:
                            f = f * ab[..., qs, t]
                        F[..., qt * SUB + t, qs * SUB + s] = f
            else:
                mid = torch.ones_like(a[..., 0])
                for qm in range(qs + 1, qt):
                    mid = mid * blk[..., qm]
                F[..., qt * SUB:(qt + 1) * SUB, qs * SUB:(qs + 1) * SUB] = \
                    (sufb[..., qs, None, :] * mid[..., None, None]) * preb[..., qt, :, None]
    M = (cb @ bb.transpose(-1, -2))[:, None] * F * dtb[..., None, :]
    bw = bb[:, None] * dtb[..., None] * suf[..., None]          # (B, H, n, L, N)
    dS = mm_3e(bw.transpose(-1, -2), xb)                        # (B, H, n, N, dh)
    starts, h = [], state
    for c in range(n):
        starts.append(h)
        h = dch[:, :, c, None, None] * h + dS[:, :, c]
    hs = torch.stack(starts, 2)                                 # (B, H, n, N, dh)
    ch = sum(cb[:, None] @ t for t in split3(hs))
    y = pre[..., None] * ch + mm_3e(M, xb)
    y = y.permute(0, 2, 3, 1, 4).reshape(Bb, n * L, H, dh)
    return y[:, :S].contiguous(), h


def ssm_scan(x, dt, B_in, C_in, A, state):
    """x: (B, S, H, dh) bf16 or fp32; dt: (B, S, H) fp32; B_in, C_in:
    (B, S, N) of x's dtype; A: (H,) fp32; state: (B, H, N, dh) fp32, read
    as the initial state and overwritten IN PLACE with the final one.
    Returns y (B, S, H, dh) fp32. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    global launches, chunked_launches
    if x.device.type == "cpu":
        y, new = ssm_scan_plain(x, dt, B_in, C_in, A, state)
        state.copy_(new)
        return y
    dtype = _launch.check_cuda_inputs("ssm_scan", x, B_in, C_in)
    B, S, H, dh = x.shape
    N = B_in.shape[-1]
    if dt.shape != (B, S, H) or B_in.shape != (B, S, N) \
            or C_in.shape != (B, S, N) or A.shape != (H,) \
            or state.shape != (B, H, N, dh):
        raise ValueError(f"ssm_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B_in.shape)}, C "
                         f"{tuple(C_in.shape)}, A {tuple(A.shape)}, state "
                         f"{tuple(state.shape)}")
    if dh not in HEAD_DIMS or not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan: dh={dh}, N={N} not supported (dh one of "
                         f"{HEAD_DIMS}, 1 <= N <= {MAX_STATE})")
    for name, t in (("dt", dt), ("A", A), ("state", state)):
        if t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be a contiguous float32 "
                             f"tensor on {x.device}")
    chunked = takes_chunked(S, x.dtype, dh, N)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    scratch = None
    if chunked:
        if any(t.data_ptr() % 16 for t in (x, state)):
            raise ValueError("ssm_scan: the chunked body needs 16-byte aligned "
                             "x and state")
        # the chunks' exchange buffer: a slot of dS and decays per chunk
        # (inside a CUDA graph, memory of the graph's pool: the kernel
        # writes every slot before a cluster barrier and reads them after
        # it, in one launch, so no call reads another's), N rounded up to the body's 16, 32 or 64 rows
        rows = 16 if N <= 16 else 32 if N <= 32 else 64
        scratch = torch.empty(B * H * -(-S // CHUNK) * (rows * dh + rows),
                              dtype=torch.float32, device=x.device)
    rc = build.load().repro_ssm_scan(
        x.data_ptr(), dt.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
        A.data_ptr(), state.data_ptr(), y.data_ptr(),
        scratch.data_ptr() if chunked else None, B, S, H, dh, N, dtype,
        _launch.stream_handle(x.device))
    if rc:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    chunked_launches += chunked
    return y
