"""The one-token decode kernels (1: contiguous cache, 3: paged), checked on
the CPU: the split rule (a pure function of the shapes and the SM count,
capped at one thread block cluster) at the served shapes, which calls take
the Hopper body (decode_sm90_kernel) and its agreement with the C rule,
the C entry points' arity against the wrappers' ctypes signatures, and
that CPU calls never count as launches. The kernels themselves run in
test_torch_gpu.py."""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels.decode_attention import paged as pg  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
H100_SMS = 132


@pytest.mark.parametrize("shape,want", [
    ((4, 8, 1024), 4),      # bursty decode, LLaMA-3.3-70B (phase 2, 3b): 128 blocks
    ((1, 8, 1024), 8),      # sporadic decode: at the cap, 64 blocks
    ((4, 5, 1024), 6),      # Hymba-1.5B (phase 3c): 120 blocks of 192 slots
    ((4, 8, 16 * 64), 4),   # kernel 3 over phase 2b's 16 pages of 64
    ((2, 8, 1024), 8),
    ((16, 8, 1024), 2),     # 132 / 128 blocks wanted: 2 splits of 512 slots
    ((72, 8, 64), 1),       # B·KV fills the card alone
    ((1, 1, 100), 2),       # a short cache: 64-slot chunks
], ids=["main", "B1", "hymba", "paged-2b", "B2", "B16", "wide", "short"])
def test_split_rule_at_the_served_shapes(shape, want):
    B, KV, S = shape
    n = da.split_count(B, KV, S, H100_SMS)
    assert n == want
    assert 1 <= n <= da.CLUSTER_MAX


@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 33, 200])
@pytest.mark.parametrize("KV", [1, 5, 8])
@pytest.mark.parametrize("S", [8, 100, 1024, 4096])
def test_split_rule_covers_the_slots_within_the_cap(B, KV, S):
    """Every slot lies in exactly one split (the kernel's chunk is
    ceil(S / n_split)), no split is empty, and no cluster is wider than
    CLUSTER_MAX."""
    n = da.split_count(B, KV, S, H100_SMS)
    assert 1 <= n <= da.CLUSTER_MAX
    chunk = -(-S // n)
    assert (n - 1) * chunk < S <= n * chunk


@pytest.mark.parametrize("dtype,dh,vec,G,want", [
    (torch.bfloat16, 128, 1, 8, True),    # LLaMA-3.3-70B
    (torch.bfloat16, 64, 1, 5, True),     # Hymba-1.5B
    (torch.bfloat16, 80, 1, 1, True),     # dh 80 runs as 128
    (torch.bfloat16, 128, 1, 16, True),
    (torch.bfloat16, 256, 1, 4, False),   # gemma3's head_dim: the FMA body
    (torch.bfloat16, 128, 0, 8, False),   # unaligned rows
    (torch.float32, 128, 1, 8, False),    # fp32
    (torch.bfloat16, 36, 1, 2, False),    # rows not whole 16-byte chunks
])
def test_hopper_decode_rule(dtype, dh, vec, G, want):
    assert da.takes_hopper_decode(dtype, dh, vec, G) is want


def test_python_rule_is_the_c_rule():
    """The wrappers' rule, split cap and tile (which their counters and
    split counts follow) are what the C body dispatches on."""
    src = (CSRC / "decode_attention.cuh").read_text()
    m = re.search(r"bool decode_sm90_takes\(int dh, int vec, int G\) \{\s*return vec != 0 "
                  r"&& dh % 8 == 0 && dh <= (\d+) && G <= (\d+);", src)
    assert m and (int(m.group(1)), int(m.group(2))) \
        == (da.HOPPER_MAX_HEAD_DIM, da.HOPPER_MAX_GROUP)
    assert "if (dtype == DTYPE_BF16 && decode_sm90_takes(dh, vec, G))" in src
    # the cluster cap lives with the merge the decode body includes
    assert '#include "cluster_merge.cuh"' in src
    merge = (CSRC / "cluster_merge.cuh").read_text()
    assert int(re.search(r"constexpr int CLUSTER_MAX = (\d+);", merge).group(1)) \
        == da.CLUSTER_MAX
    assert int(re.search(r"constexpr int SM90_TILE = (\d+);", src).group(1)) \
        == da.TILE_SLOTS
    # one launch: no second pass, no partials in global memory
    assert "combine" not in src and "part_acc" not in src


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_c_entry_points_match_their_signatures(name):
    """Each extern "C" entry point takes as many arguments as its ctypes
    signature passes (a stale one would shift every argument after it)."""
    src = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, name
    assert len(m.group(1).split(",")) == len(build.SIGNATURES[name])


def test_cpu_calls_do_not_count_as_launches():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64), np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 64), np.float32)).bfloat16()
    ids = torch.arange(32, dtype=torch.int32)
    pool = k.reshape(8, 8, 2, 64)
    bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    ctx = torch.tensor([30, 17], dtype=torch.int32)
    n = (da.launches, da.hopper_launches, pg.launches, pg.hopper_launches)
    da.decode_attention(q, k, k, ids, 20)
    pg.paged_decode_attention(q, pool, pool, bt, ctx)
    assert (da.launches, da.hopper_launches, pg.launches, pg.hopper_launches) == n
