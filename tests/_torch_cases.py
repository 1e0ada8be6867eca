"""Case lists and inputs shared by the kernel tests: the CPU tests against
the JAX package (test_torch_kernels.py) and the on-card tests
(test_torch_gpu.py). Imports no JAX, so the card's machine can run the
latter. Tolerances against the JAX package are tests/test_kernels.py's:
0.04 in bf16 (a few bf16 ulps of outputs of N(0,1) inputs, where two
implementations round probabilities at different points) and 2e-5 in
fp32 (summation order). On the card a kernel is held tighter, relative
to the reference's own size (rel_err): 2^-6 of each output vector's
largest |ref| in bf16 (2-4 ulps of that element), 2e-5 in fp32."""
import ml_dtypes
import numpy as np
import torch

BF16_TOL, F32_TOL = 0.04, 2e-5
BF16_REL, F32_REL = 2.0 ** -6, 2e-5

FLASH_CASES = [
    # B, Sq, Skv, H, KV, dh, causal, window, dtype
    (2, 64, 64, 4, 2, 64, True, None, "bf16"),
    (1, 128, 128, 8, 8, 128, True, None, "bf16"),
    (2, 64, 64, 4, 1, 32, True, 16, "bf16"),
    (1, 100, 100, 4, 2, 80, True, None, "f32"),     # unaligned dims
    (1, 64, 64, 4, 2, 64, False, None, "f32"),      # bidirectional
    (1, 96, 192, 3, 1, 64, True, None, "bf16"),     # Sq != Skv, odd H
    (1, 32, 32, 2, 2, 256, True, 8, "f32"),         # gemma3 head_dim
]

DECODE_CASES = [
    # B, S_c, H, KV, dh, pos, window, ring
    (2, 64, 4, 2, 64, 40, None, False),
    (1, 128, 8, 1, 128, 127, None, False),
    (2, 100, 4, 4, 80, 60, 32, False),
    (1, 64, 4, 2, 64, 200, None, True),
    (1, 64, 4, 2, 64, 200, 48, True),
    (3, 96, 6, 2, 32, 10, None, False),     # mostly-empty cache
]

NP_DT = {"bf16": ml_dtypes.bfloat16, "f32": np.float32}
TORCH_DT = {"bf16": torch.bfloat16, "f32": torch.float32}


def np_rand(rng, shape, dt):
    return rng.standard_normal(shape).astype(np.float32).astype(NP_DT[dt])


def to_torch(a, dt, device="cpu"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device, TORCH_DT[dt])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def rel_err(out, ref):
    """max over output vectors (last dim) of max |out - ref| / max |ref|.
    A vector whose reference is 0 (no visible key) must be exactly 0."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1)).nan_to_num(nan=0.0).max().item()


def decode_ids(S_c, pos, ring):
    ar = np.arange(S_c)
    if ring:
        base = pos - S_c + 1
        ids = (ar - (base % S_c)) % S_c + base
    else:
        ids = np.where(ar <= pos, ar, -1)
    return ids.astype(np.int32)


def flash_inputs(case, seed=0):
    B, Sq, Skv, H, KV, dh, causal, window, dt = case
    rng = np.random.default_rng(seed)
    return (np_rand(rng, (B, Sq, H, dh), dt), np_rand(rng, (B, Skv, KV, dh), dt),
            np_rand(rng, (B, Skv, KV, dh), dt))


def decode_inputs(case, seed=0):
    B, S_c, H, KV, dh, pos, window, ring = case
    rng = np.random.default_rng(seed)
    return (np_rand(rng, (B, 1, H, dh), "bf16"), np_rand(rng, (B, S_c, KV, dh), "bf16"),
            np_rand(rng, (B, S_c, KV, dh), "bf16"), decode_ids(S_c, pos, ring))


