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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch, build

HEAD_DIMS = (32, 64, 128)   # the kernel's compiled column counts

launches = 0          # kernel launches since the last reset (main-path proof)


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


def wkv(r, k, v, w, u, state):
    """r, k, v: (B, S, H, dh) bf16 or fp32; w: (B, S, H, dh) fp32; u:
    (H, dh) of r's dtype; state: (B, H, dh, dh) fp32, read as the initial
    state and overwritten IN PLACE with the final one. Returns out
    (B, S, H, dh) fp32. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global launches
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
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    rc = build.load().repro_wkv_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), out.data_ptr(), B, S, H, dh, dtype,
        _launch.stream_handle(r.device))
    if rc:
        raise RuntimeError(f"wkv kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
