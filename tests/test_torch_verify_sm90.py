"""The verify regime of the multi-query kernels (4: contiguous cache, 5:
paged), checked on the CPU: which body a call takes (verify_sm90_kernel,
the Hopper mainloop or the mma.sync body) and its agreement with the C
rule, the verify body's split rule (a pure function of the shapes and the
SM count, capped at one thread block cluster, no split empty, at least two
tiles a block at the verify shape), the C entry points' arity (no fp32
partials passed any more) and that no second pass is left. The kernels
themselves run in test_torch_gpu.py."""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import multiquery as mq  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
H100_SMS = 132


@pytest.mark.parametrize("shape,want", [
    ((4, 8, 1024), 4),      # a bursty verify pass (phases 3a, 3b): 128 blocks
    ((1, 8, 1024), 8),      # a sporadic one: at the cap, 64 blocks
    ((4, 8, 16 * 64), 4),   # kernel 5 over phase 2b's 16 pages of 64
    ((2, 8, 1024), 8),
    ((16, 8, 1024), 2),     # 128 blocks already: 2 splits of 512 slots
    ((33, 4, 1024), 1),     # B·KV fills the card alone
    ((1, 1, 100), 1),       # a short cache: one block of two tiles
], ids=["main", "B1", "paged-2b", "B2", "B16", "wide", "short"])
def test_verify_split_rule_at_the_served_shapes(shape, want):
    B, KV, S = shape
    assert mq.verify_split_count(B, KV, S, H100_SMS) == want


@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 33, 200])
@pytest.mark.parametrize("KV", [1, 5, 8, 19])
@pytest.mark.parametrize("S", [8, 100, 640, 1024, 4096])
def test_verify_split_rule_covers_the_slots_within_the_cap(B, KV, S):
    """Every slot lies in exactly one split (the kernel's chunk is
    ceil(S / n_split) rounded up to whole 64-slot tiles), no split is
    empty, no cluster is wider than CLUSTER_MAX, and a split holds at
    least two tiles unless the cache is shorter."""
    n = mq.verify_split_count(B, KV, S, H100_SMS)
    assert 1 <= n <= mq.CLUSTER_MAX == da.CLUSTER_MAX
    T = mq.TILE_SLOTS
    chunk = T * -(-(-(-S // n)) // T)
    assert (n - 1) * chunk < S <= n * chunk
    if n > 1:
        assert chunk >= 2 * T
    # pure: the same shapes give the same count
    assert mq.verify_split_count(B, KV, S, H100_SMS) == n


def test_verify_shape_walks_at_least_two_tiles_a_block():
    """B 4, q_len 5, H 64, KV 8, S 1024: 128 blocks of 256 slots."""
    n = mq.n_splits(mq.mq_body(5, 8, 128, 1), 4, 5, 64, 8, 1024, H100_SMS)
    assert n == 4 and 1024 // n // mq.TILE_SLOTS == 4
    assert 4 * 8 * n <= H100_SMS


@pytest.mark.parametrize("B", [1, 4, 33])
@pytest.mark.parametrize("Q", [1, 5, 9, 130])
@pytest.mark.parametrize("S", [100, 1024])
def test_mma_split_rule_stays_within_the_cap(B, Q, S):
    """The mma.sync body merges its splits in a cluster too: at most
    CLUSTER_MAX, none empty."""
    n = mq.split_count(B, Q, 64, 8, S, H100_SMS)
    assert 1 <= n <= mq.CLUSTER_MAX
    chunk = -(-S // n)
    assert (n - 1) * chunk < S <= n * chunk


@pytest.mark.parametrize("shape,vec,want", [
    ((5, 8, 128), 1, "verify"),      # a k = 4 verify pass, LLaMA-3.3-70B
    ((9, 8, 128), 1, "verify"),      # k = 8: 72 rows
    ((1, 8, 128), 1, "verify"),      # one token
    ((16, 8, 128), 1, "verify"),     # 128 rows: the edge
    ((17, 8, 128), 1, "mainloop"),   # 136 rows
    ((128, 8, 128), 1, "mainloop"),  # a prefill round (B 1 or B 4)
    ((5, 1, 64), 1, "verify"),       # G 1
    ((5, 8, 80), 1, "verify"),       # dh 80 runs as 128
    ((5, 8, 256), 1, "mma"),         # dh 256
    ((5, 8, 128), 0, "mma"),         # unaligned rows
    ((5, 8, 36), 1, "mma"),          # rows not whole 16-byte chunks
], ids=["verify", "k8", "q1", "128rows", "136rows", "round", "G1", "dh80",
        "dh256", "unaligned", "dh36"])
def test_body_rule(shape, vec, want):
    Q, G, dh = shape
    assert mq.mq_body(Q, G, dh, vec) == want
    n = mq.n_splits(want, 4, Q, 8 * G, 8, 1024, H100_SMS)
    assert n == {"verify": mq.verify_split_count(4, 8, 1024, H100_SMS),
                 "mainloop": 1}.get(want, mq.split_count(4, Q, 8 * G, 8, 1024, H100_SMS))


def test_python_body_rule_is_the_c_rule():
    """mq_body in multiquery.py (which the verify and Hopper counters and
    the split counts follow) is what dispatch_mq launches."""
    src = (CSRC / "mq_decode_attention.cuh").read_text()
    assert re.search(r"inline int mq_body\(int dh, int vec, int Q, int G\) \{\s*"
                     r"if \(!sm90::takes\(dh, vec, G\)\) return MQ_MMA;\s*"
                     r"return Q \* G <= VERIFY_ROWS \? MQ_VERIFY : MQ_MAINLOOP;", src)
    assert int(re.search(r"constexpr int VERIFY_ROWS = (\d+);", src).group(1)) \
        == mq.VERIFY_ROWS
    assert int(re.search(r"constexpr int VF_TILE = (\d+);", src).group(1)) \
        == mq.TILE_SLOTS
    assert int(re.search(r"constexpr int MQ_BN = (\d+);", src).group(1)) == mq.TILE_SLOTS
    assert int(re.search(r"constexpr int MQ_BM = (\d+);", src).group(1)) \
        == mq.ROWS_PER_BLOCK
    assert "const int body = mq_body(dh, vec, Q, G);" in src
    assert "if (n_split != 1) return (int)cudaErrorInvalidValue;" in src
    merge = (CSRC / "cluster_merge.cuh").read_text()
    assert int(re.search(r"constexpr int CLUSTER_MAX = (\d+);", merge).group(1)) \
        == mq.CLUSTER_MAX


def test_one_launch_and_no_partials_in_global_memory():
    """No mq_combine_kernel (or any second pass) is left to reach, and the
    C entry points take no fp32 partials: q, K, V, ids (or tables and
    ctx), out, then the shapes (the contiguous kernel's position among
    them as a device pointer, read on the device)."""
    for p in sorted(CSRC.glob("*.cu*")):
        src = p.read_text()
        assert "mq_combine_kernel" not in src and "part_acc" not in src, p.name
        assert not re.search(r"__global__[^(]*combine", src), p.name
    P, I, F = build.P, build.I, build.F
    assert build.SIGNATURES["repro_mq_decode_attention"] \
        == [P] * 5 + [I] * 6 + [P] + [I] + [F] + [I] * 3 + [P]
    assert build.SIGNATURES["repro_mq_paged_decode_attention"] \
        == [P] * 6 + [I] * 9 + [F] + [I] * 3 + [P]
    src = "".join(p.read_text() for p in sorted(CSRC.glob("mq_*.cu")))
    for name in ("repro_mq_decode_attention", "repro_mq_paged_decode_attention"):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m and "part" not in m.group(1)
        assert len(m.group(1).split(",")) == len(build.SIGNATURES[name])


def test_the_merge_is_shared_not_copied():
    """One ClusterMerge (cluster_merge.cuh) serves the decode and the
    multi-query bodies."""
    heads = {p.name: p.read_text() for p in CSRC.glob("*.cuh")}
    defining = [n for n, s in heads.items() if "struct ClusterMerge" in s]
    assert defining == ["cluster_merge.cuh"]
    for name in ("decode_attention.cuh", "mq_decode_attention.cuh"):
        assert '#include "cluster_merge.cuh"' in heads[name]
        assert "ClusterMerge<" in heads[name]


def test_cpu_calls_do_not_count_as_verify_launches():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 5, 8, 64), np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 64), np.float32)).bfloat16()
    ids = torch.arange(32, dtype=torch.int32)
    pool = k.reshape(8, 8, 2, 64)
    bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    ctx = torch.tensor([30, 17], dtype=torch.int32)
    n = (mq.launches, mq.verify_sm90_launches, mq.paged_launches,
         mq.paged_verify_sm90_launches)
    mq.mq_decode_attention(q, k, k, ids, 20)
    mq.mq_paged_decode_attention(q, pool, pool, bt, ctx)
    assert (mq.launches, mq.verify_sm90_launches, mq.paged_launches,
            mq.paged_verify_sm90_launches) == n
