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
    (1, 64, 64, 10, 2, 64, True, 32, "bf16"),       # G 5 (Hymba's grouping)
    (2, 64, 64, 8, 2, 160, True, None, "bf16"),     # G 4, dh 160 (StableLM-2)
]

DECODE_CASES = [
    # B, S_c, H, KV, dh, pos, window, ring
    (2, 64, 4, 2, 64, 40, None, False),
    (1, 128, 8, 1, 128, 127, None, False),
    (2, 100, 4, 4, 80, 60, 32, False),
    (1, 64, 4, 2, 64, 200, None, True),
    (1, 64, 4, 2, 64, 200, 48, True),
    (3, 96, 6, 2, 32, 10, None, False),     # mostly-empty cache
    (2, 96, 10, 2, 64, 70, 64, False),      # G 5 (Hymba's grouping), window
    (2, 96, 8, 2, 160, 70, None, False),    # G 4, dh 160 (StableLM-2)
]

# The Hopper decode body (decode_sm90_kernel) at its ring's and cluster's
# edges: split counts 1 to 8 (the cluster cap), G 1-16, dh 64 / 80 / 128,
# caches that are not whole 64-slot tiles, a ring with a window, a head
# with no visible slot (pos -1: every pos_id lies past it).
DECODE_SM90_CASES = [
    # B, S_c, H, KV, dh, pos, window, ring
    (4, 1024, 64, 8, 128, 1023, None, False),        # main: 4 splits
    (1, 1024, 64, 8, 128, 543, None, False),         # B 1: 8 splits, 5 live
    (4, 1024, 25, 5, 64, 543, 1024, False),          # Hymba: G 5, window
    (72, 64, 64, 8, 128, 63, None, False),           # B·KV 576: 1 split
    (2, 100, 16, 2, 128, 99, None, False),           # S_c % 64 != 0
    (2, 77, 2, 2, 64, 70, None, False),              # G 1, S_c 77
    (2, 300, 32, 2, 128, 299, None, False),          # G 16
    (1, 130, 16, 1, 64, 100, 40, False),             # G 16, dh 64, window
    (2, 200, 16, 2, 80, 150, None, False),           # dh 80 in 128
    (2, 512, 64, 8, 128, 1500, 300, True),           # ring + window
    (2, 64, 16, 2, 64, -1, None, False),             # nothing visible
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
    (2, 5, 64, 4, 4, 64, 40, None, "stale"),         # G 1: a verify pass
    (1, 9, 80, 2, 2, 32, 60, 4, "ring"),             # G 1, window < q_len
    (2, 5, 64, 8, 2, 160, 40, None, "stale"),        # G 4, dh 160 (StableLM-2)
]

# The verify body (verify_sm90_kernel, kernels 4 and 5 at q_len·G <= 128)
# at its edges: q_len 1-9, split counts 1 to 8 (the cluster cap; the count
# each case gets on 132 SMs in the comment), 4 and 8 warps (40, 72, 128
# rows), G 1 / 2 / 8 / 16, dh 64 / 80 / 128, caches that are not whole
# 64-slot tiles, windows shorter than q_len, stale ids past every row's
# position, rows that see nothing.
VERIFY_SM90_CASES = [
    # B, q_len, S_c, H, KV, dh, pos, window, cache kind (as MQ_CASES)
    (4, 5, 1024, 64, 8, 128, 1019, None, "linear"),     # main: 4 splits
    (1, 5, 1024, 64, 8, 128, 516, None, "linear"),      # sporadic: 8, half empty
    (33, 2, 1024, 4, 2, 64, 1000, None, "linear"),      # 2 splits of 512
    (11, 3, 1024, 16, 4, 64, 1021, None, "stale"),      # 3 splits of 384
    (4, 5, 640, 64, 8, 128, 600, None, "stale"),        # 5 splits of 128
    (11, 5, 1024, 16, 2, 128, 1019, None, "linear"),    # 6 splits of 192
    (1, 5, 896, 38, 19, 64, 891, None, "linear"),       # 7 splits, G 2
    (132, 2, 128, 16, 8, 128, 100, None, "linear"),     # 1 split
    (2, 1, 300, 16, 2, 128, 299, None, "linear"),       # q_len 1
    (1, 9, 1000, 64, 8, 128, 900, None, "stale"),       # 72 rows: 8 warps
    (2, 8, 512, 32, 2, 128, 400, None, "linear"),       # G 16: 128 rows
    (2, 3, 100, 4, 4, 64, 90, None, "linear"),          # G 1, S_c 100
    (3, 7, 777, 8, 8, 80, 700, 5, "ring"),              # G 1, dh 80, window 5
    (1, 4, 64, 16, 2, 64, 40, 2, "linear"),             # window 2 < q_len 4
    (2, 6, 200, 16, 2, 64, 150, None, "first-masked"),  # row 0 sees nothing
    (1, 3, 200, 16, 2, 128, 5, None, "masked"),         # no row sees a slot
    (4, 5, 1024, 40, 40, 128, 1019, None, "linear"),    # LLaMA-2-13B: G 1, KV 40
]

# Shapes the Hopper mainloop (csrc/attention_sm90.cuh) takes: flash at
# tile edges (Sq, Skv not multiples of 64 or 128; 128 rows a block are
# 128 / G positions), and the multi-query prefill regime (unsplit: at
# B 4, KV 8, G 8, q_len 128 already fills 512 blocks).
FLASH_HOPPER_CASES = [
    # B, Sq, Skv, H, KV, dh, causal, window, q_offset
    (1, 100, 230, 10, 2, 80, True, 100, 130),        # dh 80, window 100
    (1, 77, 77, 16, 2, 128, True, None, 0),          # G 8, one ragged block
    (2, 200, 200, 8, 1, 128, True, 100, 0),          # G 8, window 100
    (2, 130, 300, 10, 2, 64, True, 1024, 170),       # G 5, window 1024
    (4, 129, 129, 25, 5, 64, True, 1024, 0),         # Hymba's heads, S 129
    (1, 129, 191, 10, 2, 64, False, 100, 0),         # bidirectional window
    (2, 64, 64, 4, 1, 32, True, 16, 0),              # dh 32 in a 64 box
]

MQ_HOPPER_CASES = [
    # B, q_len, S_c, H, KV, dh, pos, window, cache kind (as MQ_CASES)
    (4, 128, 1024, 64, 8, 128, 891, None, "linear"),
    (4, 512, 1024, 64, 8, 128, 0, 300, "linear"),
    (4, 128, 1024, 64, 8, 128, 1500, 700, "ring"),
    (4, 128, 1024, 64, 8, 128, 300, None, "stale"),
    (4, 128, 700, 64, 8, 80, 333, None, "linear"),   # dh 80, S_c % 64 != 0
    (4, 512, 1024, 40, 40, 128, 0, None, "linear"),  # LLaMA-2-13B's round: G 1
    (2, 200, 512, 4, 4, 128, 100, 150, "stale"),     # G 1, window
]

MQ_PAGED_HOPPER_CASES = [
    # B, q_len, H, KV, dh, page_size, max_pages, ctx_lens, window
    (4, 128, 64, 8, 128, 64, 16, (1019, 700, 300, 130), None),
    (4, 128, 64, 8, 128, 16, 64, (1019, 700, 300, 130), 300),
    (4, 512, 64, 8, 128, 64, 16, (1000, 900, 600, 512), None),
    (4, 512, 64, 8, 128, 16, 64, (1024, 777, 513, 640), 256),
    (4, 128, 64, 8, 128, 24, 43, (1019, 700, 300, 130), None),  # 8-row boxes
    (4, 512, 40, 40, 128, 64, 16, (1000, 900, 600, 512), None),  # G 1
    (2, 200, 4, 4, 128, 16, 40, (600, 333), 150),               # G 1, window
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
    (2, 8, 2, 160, 16, 4, (50, 23), None),           # G 4, dh 160 (StableLM-2)
]

# The Hopper decode body through block tables: page sizes 8, 24, 64.
PAGED_SM90_CASES = [
    # B, H, KV, dh, page_size, max_pages, ctx_lens, window
    (4, 64, 8, 128, 64, 16, (1019, 700, 300, 130), None),
    (4, 64, 8, 128, 8, 128, (1019, 700, 300, 130), 500),
    (3, 25, 5, 64, 24, 43, (1019, 545, 24), 1024),   # Hymba's heads
    (2, 32, 2, 80, 24, 10, (239, 7), None),          # dh 80, G 16
]

MQ_PAGED_CASES = [
    # B, q_len, H, KV, dh, page_size, max_pages, ctx_lens (incl. the q_len
    # new tokens), window
    (2, 1, 8, 2, 64, 8, 5, (33, 17), None),
    (2, 4, 8, 2, 64, 16, 4, (50, 9), None),
    (1, 4, 4, 1, 80, 8, 6, (44,), 12),               # dh 80, window
    (2, 9, 16, 2, 64, 16, 4, (64, 20), None),        # q_len 9, G 8
    (3, 9, 4, 2, 80, 8, 5, (9, 25, 40), 7),          # window < q_len
    (2, 5, 4, 4, 64, 8, 6, (45, 30), None),          # G 1: a verify pass
    (2, 3, 2, 2, 64, 16, 4, (50, 7), 2),             # G 1, window < q_len
    (2, 5, 8, 8, 128, 16, 8, (100, 37), None),       # G 1, dh 128 (LLaMA-2)
]

# The verify body through block tables (main path: page 64, 16 pages;
# page 16 and 8; ragged ctx; a window; G 1)
MQ_PAGED_VERIFY_CASES = [
    # B, q_len, H, KV, dh, page_size, max_pages, ctx_lens, window
    (4, 5, 64, 8, 128, 64, 16, (1019, 700, 300, 130), None),
    (1, 5, 64, 8, 128, 64, 16, (516,), None),
    (4, 9, 64, 8, 128, 16, 64, (1019, 700, 300, 130), 300),
    (3, 3, 8, 8, 64, 8, 100, (777, 21, 3), 2),
    (2, 1, 16, 2, 80, 24, 43, (1000, 517), None),
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


# Recurrent scans: tests/test_kernels.py's WKV_CASES (B, S, H, dh; its
# block_t is a TPU tiling with no counterpart here) and SSM_CASES (B, S,
# H, dh, N), plus the decode shape (S = 1). Both scans run in fp32; the
# kernels differ from their plain versions (and those from the JAX scans)
# by summation order only: SCAN_REL of each output vector's largest |ref|.
WKV_CASES = [
    # B, S, H, dh
    (2, 32, 4, 64), (1, 64, 2, 32), (2, 50, 3, 64), (1, 16, 1, 128),
    (1, 7, 2, 64), (3, 1, 4, 64),
]
SSM_CASES = [
    # B, S, H, dh, N
    (2, 32, 4, 64, 16), (1, 50, 2, 32, 8), (1, 16, 3, 128, 16),
    (2, 24, 5, 64, 16), (3, 1, 5, 64, 16),
]
SCAN_REL = 1e-4


def wkv_inputs(case, seed=0, state=True):
    """r, k, v, w, u, initial state as fp32 numpy arrays (the JAX tests'
    distributions); state=False starts from zeros."""
    B, S, H, dh = case
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32) * 0.5
               for _ in range(3))
    w = 1 / (1 + np.exp(-rng.standard_normal((B, S, H, dh)))) * 0.9 + 0.05
    u = rng.standard_normal((H, dh)) * 0.1
    s0 = rng.standard_normal((B, H, dh, dh)) * 2 if state \
        else np.zeros((B, H, dh, dh))
    return (r, k, v, w.astype(np.float32), u.astype(np.float32),
            s0.astype(np.float32))


def ssm_inputs(case, seed=0, state=True):
    """x, dt, B_in, C_in, A, initial state as fp32 numpy arrays (the JAX
    tests' distributions); state=False starts from zeros."""
    B, S, H, dh, N = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, dh)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    bm, cm = (rng.standard_normal((B, S, N)) * 0.5 for _ in range(2))
    A = -np.exp(rng.standard_normal(H) * 0.3)
    s0 = rng.standard_normal((B, H, N, dh)) if state \
        else np.zeros((B, H, N, dh))
    return tuple(a.astype(np.float32) for a in (x, dt, bm, cm, A, s0))
