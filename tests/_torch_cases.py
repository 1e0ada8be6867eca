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

MQ_CASES = [
    # B, q_len, S_c, H, KV, dh, pos, window, cache kind: "linear" (slots
    # up to pos + q_len - 1 filled), "ring" (a ring buffer after position
    # pos + q_len - 1), "stale" (slots past the window hold positions of a
    # rejected round, pos_ids > every query's), "masked" (every slot after
    # every query: all rows see nothing), "first-masked" (row 0 sees
    # nothing, later rows see the slots they reach)
    (2, 3, 24, 4, 2, 16, 11, None, "linear"),
    (2, 5, 64, 8, 2, 64, 40, None, "stale"),
    (1, 4, 64, 4, 1, 80, 30, 16, "linear"),          # dh 80, window
    (2, 4, 64, 4, 2, 64, 200, 48, "ring"),
    (1, 9, 96, 16, 2, 128, 60, None, "stale"),       # q_len 9, G 8
    (1, 3, 32, 4, 2, 32, 5, None, "masked"),
    (1, 3, 32, 4, 2, 32, 5, None, "first-masked"),
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


def mq_ids(S_c, pos, Q, kind):
    """pos_ids of a cache holding the q_len new positions pos .. pos+Q-1."""
    ar = np.arange(S_c)
    last = pos + Q - 1
    if kind == "ring":
        return decode_ids(S_c, last, True)
    if kind == "stale":
        ids = np.where(ar <= last + 6, ar, -1)
    elif kind == "masked":
        ids = ar + pos + Q
    elif kind == "first-masked":
        ids = np.where(ar < Q - 1, pos + 1 + ar, -1)
    else:
        ids = np.where(ar <= last, ar, -1)
    return ids.astype(np.int32)


def mq_inputs(case, seed=0):
    B, Q, S_c, H, KV, dh, pos, window, kind = case
    rng = np.random.default_rng(seed)
    return (np_rand(rng, (B, Q, H, dh), "bf16"), np_rand(rng, (B, S_c, KV, dh), "bf16"),
            np_rand(rng, (B, S_c, KV, dh), "bf16"), mq_ids(S_c, pos, Q, kind))


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




# Paged cases. Tables come from the port's PageAllocator after a churn of
# allocations and LIFO frees, handed out page by page across the batch, so
# they are non-contiguous and interleaved; a table's tail past its
# sequence's pages is -1; ctx_lens are ragged.
PAGED_CASES = [
    # B, H, KV, dh, page_size, max_pages, ctx_lens, window
    (3, 8, 2, 64, 8, 5, (33, 17, 40), None),
    (2, 4, 1, 80, 16, 4, (50, 64), 20),              # dh 80, window
    (2, 16, 2, 128, 16, 3, (5, 48), None),           # G 8
    (1, 4, 4, 64, 8, 6, (41,), 9),                   # window in a page
    (2, 8, 2, 64, 16, 4, (1, 30), None),             # one live slot
]

MQ_PAGED_CASES = [
    # B, q_len, H, KV, dh, page_size, max_pages, ctx_lens (incl. the q_len
    # new tokens), window
    (2, 1, 8, 2, 64, 8, 5, (33, 17), None),
    (2, 4, 8, 2, 64, 16, 4, (50, 9), None),
    (1, 4, 4, 1, 80, 8, 6, (44,), 12),               # dh 80, window
    (2, 9, 16, 2, 64, 16, 4, (64, 20), None),        # q_len 9, G 8
    (3, 9, 4, 2, 80, 8, 5, (9, 25, 40), 7),          # window < q_len
]


def lifo_tables(ctx_lens, page_size, max_pages, seed=0):
    """(block_tables (B, max_pages) int32 with -1 tails, pool page count)."""
    from repro_torch.kvcache.allocator import PageAllocator
    rng = np.random.default_rng(seed)
    need = [-(-c // page_size) for c in ctx_lens]
    n_pages = sum(need) + 3
    alloc = PageAllocator(n_pages, page_size)
    churn = alloc.alloc_many(n_pages // 2)
    rng.shuffle(churn)
    for pid in churn:                   # LIFO: the last freed goes out first
        alloc.decref(pid)
    bt = np.full((len(ctx_lens), max_pages), -1, np.int32)
    for j in range(max(need)):
        for b, n in enumerate(need):
            if j < n:
                bt[b, j] = alloc.alloc()
    return bt, n_pages


def paged_inputs(B, Q, H, KV, dh, ps, maxp, ctx, seed=0):
    """q (B, Q, H, dh), k/v pools (P, ps, KV, dh) bf16 numpy, tables, ctx."""
    bt, P = lifo_tables(ctx, ps, maxp, seed)
    rng = np.random.default_rng(seed + 1)
    return (np_rand(rng, (B, Q, H, dh), "bf16"),
            np_rand(rng, (P, ps, KV, dh), "bf16"),
            np_rand(rng, (P, ps, KV, dh), "bf16"), bt,
            np.asarray(ctx, np.int32))


def paged_case_inputs(case, seed=0):
    B, H, KV, dh, ps, maxp, ctx, window = case
    return paged_inputs(B, 1, H, KV, dh, ps, maxp, ctx, seed)


def mq_paged_case_inputs(case, seed=0):
    B, Q, H, KV, dh, ps, maxp, ctx, window = case
    return paged_inputs(B, Q, H, KV, dh, ps, maxp, ctx, seed)


def gathered_ids(n_slots, ctx):
    """pos_ids of one sequence's cache gathered from its pages: slot t holds
    position t below ctx, nothing past it."""
    ar = np.arange(n_slots)
    return np.where(ar < ctx, ar, -1).astype(np.int32)
