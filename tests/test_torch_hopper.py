"""Which calls run the Hopper mainloop (``csrc/attention_sm90.cuh``: wgmma,
TMA, a warp-specialised pipeline), checked on the CPU: the wrappers' rule
at the main path's shapes and its agreement with the C entry points', and
that no module of the port hands attention to a library (SDPA,
torch.compile, cuDNN). The kernels themselves run in test_torch_gpu.py."""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _launch  # noqa: E402
from repro_torch.kernels.decode_attention import multiquery as mq  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
H100_SMS = 132


@pytest.mark.parametrize("shape,want", [
    ((4, 128, 64, 8, 1024, 128), "mainloop"),  # kernel 5's prefill round (2b)
    ((4, 512, 64, 8, 1024, 128), "mainloop"),  # kernel 4's chunked prefill
    ((4, 5, 64, 8, 1024, 128), "verify"),      # a k = 4 verify pass: 40 rows
    ((4, 1, 64, 8, 1024, 128), "verify"),      # one token
    ((1, 128, 64, 8, 1024, 128), "mainloop"),  # 1024 rows: unsplit
    ((4, 128, 64, 8, 1024, 256), "mma"),       # dh 256: the mma.sync body
    ((4, 128, 64, 8, 1024, 80), "mainloop"),   # dh 80 runs as 128
    ((4, 512, 25, 5, 1024, 64), "mainloop"),   # Hymba's heads
], ids=["k5-round", "k4-round", "verify", "q1", "B1", "dh256", "dh80", "G5"])
def test_mq_dispatch_rule_at_the_main_shapes(shape, want):
    """The Hopper mainloop takes the aligned calls of more than 128 rows,
    unsplit; the verify body (verify_sm90_kernel) those of at most 128,
    split by its own rule; unaligned rows take neither."""
    B, Q, H, KV, S, dh = shape
    G = H // KV
    assert mq.mq_body(Q, G, dh, vec=1) == want
    assert mq.mq_body(Q, G, dh, vec=0) == "mma"
    n_split = mq.n_splits(want, B, Q, H, KV, S, H100_SMS)
    if want == "mainloop":
        assert n_split == 1
    elif want == "verify":
        assert n_split == mq.verify_split_count(B, KV, S, H100_SMS) > 1


@pytest.mark.parametrize("dtype,dh,vec,G,want", [
    (torch.bfloat16, 128, 1, 8, True),    # LLaMA
    (torch.bfloat16, 64, 1, 5, True),     # Hymba
    (torch.bfloat16, 80, 1, 1, True),
    (torch.bfloat16, 256, 1, 4, False),   # gemma3's head_dim: mma.sync
    (torch.bfloat16, 128, 0, 8, False),   # unaligned rows
    (torch.float32, 128, 1, 8, False),    # the fp32 SIMT kernel
    (torch.bfloat16, 64, 1, 256, False),  # a group wider than an item
])
def test_flash_dispatch_rule(dtype, dh, vec, G, want):
    assert fa.takes_hopper_mainloop(dtype, dh, vec, G) is want


def test_python_rule_is_the_c_rule():
    """The wrappers' rule (which their hopper counters follow) is what the
    C entry points dispatch on."""
    src = (CSRC / "attention_sm90.cuh").read_text()
    m = re.search(r"bool takes\(int dh, int vec, int G\) \{\s*return vec != 0 && "
                  r"dh % 8 == 0 && dh <= (\d+) && G <= BM;", src)
    assert m and int(m.group(1)) == _launch.HOPPER_MAX_HEAD_DIM
    m = re.search(r"constexpr int CONSUMERS = (\d+);", src)
    assert "constexpr int BM = 64 * CONSUMERS;" in src
    assert 64 * int(m.group(1)) == _launch.HOPPER_ROWS
    mq_src = (CSRC / "mq_decode_attention.cuh").read_text()
    assert "if (!sm90::takes(dh, vec, G)) return MQ_MMA;" in mq_src
    assert "if (body == MQ_MAINLOOP) {\n    if (n_split != 1)" in mq_src
    assert "sm90::takes(dh, vec, H / KV)" \
        in (CSRC / "flash_attention.cu").read_text()


def test_cpu_calls_do_not_count_as_hopper_launches():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 8, 64), generator=g).bfloat16()
    k = torch.randn((1, 16, 2, 64), generator=g).bfloat16()
    ids = torch.arange(16, dtype=torch.int32)
    n = (fa.launches, fa.hopper_launches, mq.launches, mq.hopper_launches)
    fa.flash_attention(q, k, k)
    mq.mq_decode_attention(q, k, k, ids, 12)
    assert (fa.launches, fa.hopper_launches, mq.launches,
            mq.hopper_launches) == n


LIBRARY_ATTENTION = re.compile(
    r"scaled_dot_product_attention|torch\.compile|cudnn|_flash_attention_forward"
    r"|_efficient_attention|torch\.nn\.attention")
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted(CSRC.glob("*.cu*"))


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_attention(path):
    found = LIBRARY_ATTENTION.findall(path.read_text())
    assert not found, f"{path.name} uses {sorted(set(found))}"
