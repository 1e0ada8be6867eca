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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch, build

HEAD_DIMS = (32, 64, 128)   # the kernel's compiled column counts
MAX_STATE = 64              # largest N the kernel's registers hold

launches = 0          # kernel launches since the last reset (main-path proof)


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


def ssm_scan(x, dt, B_in, C_in, A, state):
    """x: (B, S, H, dh) bf16 or fp32; dt: (B, S, H) fp32; B_in, C_in:
    (B, S, N) of x's dtype; A: (H,) fp32; state: (B, H, N, dh) fp32, read
    as the initial state and overwritten IN PLACE with the final one.
    Returns y (B, S, H, dh) fp32. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    global launches
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
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rc = build.load().repro_ssm_scan(
        x.data_ptr(), dt.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
        A.data_ptr(), state.data_ptr(), y.data_ptr(), B, S, H, dh, N, dtype,
        _launch.stream_handle(x.device))
    if rc:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return y
