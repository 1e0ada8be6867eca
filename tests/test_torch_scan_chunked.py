"""The chunked (matrix-form) bodies of the recurrent scans (kernel 6: WKV,
kernel 7: selective scan), checked on the CPU.

The CUDA bodies run only on the card (tests/test_torch_gpu.py, marked
gpu). Here their arithmetic is held through its plain PyTorch model
(``wkv_chunked_plain``, ``ssm_scan_chunked_plain``: chunks anchored at the
call's first step, running products of the decays, the three-term bf16
operands of the tensor-core products emulated with casts, the recurrence
over chunk states in chunk order):

* against the JAX package's jnp scans (``repro.models.ssm.wkv_scan_ref``,
  ``ssm_scan_ref``) within SCAN_REL of each vector's largest |ref|, from a
  zero and a random state, at S 128, 129, 200 and 512 (bf16 inputs, as the
  chunked body takes them);
* at extreme decays (w = 0 and 1e-30 at chosen steps, 1e-30 and 1 - 1e-6
  everywhere; dt 20 at chosen steps or everywhere): no NaN, and within
  SCAN_REL of an fp64 evaluation. Such decays reset the state, and an
  output that is then one fresh term (r_t·k_s, C_t·B_s) can nearly
  cancel: the fp32 sequential scan itself is up to 5e-4 off fp64 there,
  the chunked model (three-term operands) about 1e-5;
* two calls split at a multiple of the chunk length equal one call bit for
  bit (the chunk grid starts at each call's first step); a split elsewhere
  is within SCAN_REL;
* a planted chunk fault (a chunk's state carried without its decay) is
  rejected by SCAN_REL;
* the rule that picks the body (Python and C alike), the C entry points'
  arity, and that CPU calls never count as launches.
"""
import pathlib
import re
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_cases import SCAN_REL, rel_err, ssm_inputs, wkv_inputs  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
bf16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_exact(a):
    """numpy fp32 rounded to bf16 values (kept as fp32): the model's types,
    handed alike to the port (as bf16) and to JAX (as fp32)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _wkv(case, seed=0, state=True):
    r, k, v, w, u, s0 = wkv_inputs(case, seed=seed, state=state)
    r, k, v, u = map(_bf16_exact, (r, k, v, u))
    return r, k, v, w, u, s0


def _ssm(case, seed=0, state=True):
    x, dt, bm, cm, A, s0 = ssm_inputs(case, seed=seed, state=state)
    x, bm, cm = map(_bf16_exact, (x, bm, cm))
    return x, dt, bm, cm, A, s0


def _port(args, bf):
    return [_t(a).to(bf16) if i in bf else _t(a) for i, a in enumerate(args)]


WKV_BF = (0, 1, 2, 4)
SSM_BF = (0, 2, 3)


@pytest.mark.parametrize("state", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("case", [(1, 128, 2, 64), (2, 129, 2, 64), (1, 200, 3, 32),
                                  (1, 200, 2, 128), (1, 512, 2, 64)],
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}")
def test_wkv_chunked_model_vs_jax(case, state):
    args = _wkv(case, state=state)
    ref_o, ref_s = JS.wkv_scan_ref(*map(jnp.asarray, args))
    out, new = wkv_ops.wkv_chunked_plain(*_port(args, WKV_BF))
    assert rel_err(out, _t(ref_o)) <= SCAN_REL
    assert rel_err(new, _t(ref_s)) <= SCAN_REL


@pytest.mark.parametrize("state", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("case", [(1, 128, 3, 64, 16), (2, 129, 2, 64, 16),
                                  (1, 200, 2, 32, 8), (1, 200, 2, 128, 64),
                                  (1, 512, 3, 64, 16)],
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}N{c[4]}")
def test_ssm_chunked_model_vs_jax(case, state):
    args = _ssm(case, state=state)
    ref_y, ref_s = JS.ssm_scan_ref(*map(jnp.asarray, args))
    y, new = ssm_ops.ssm_scan_chunked_plain(*_port(args, SSM_BF))
    assert rel_err(y, _t(ref_y)) <= SCAN_REL
    assert rel_err(new, _t(ref_s)) <= SCAN_REL


# extreme decays: (label, w from the inputs' w and a seeded rng)
CHOSEN = np.array([0, 5, 63, 64, 65, 130, 255, 300, 511])


def _w_extreme(kind, w, rng):
    w = w.copy()
    if kind == "w 0 at chosen steps":
        w[:, CHOSEN] = 0.0
    elif kind == "w 1e-30 at chosen steps":
        w[:, CHOSEN] = 1e-30
    elif kind == "w 1e-30 everywhere":
        w[:] = 1e-30
    elif kind == "w 1 - 1e-6 everywhere":
        w[:] = 1 - 1e-6
    else:                              # a mix of both ends
        w = np.where(rng.random(w.shape) < 0.3, 1e-30, 1 - 1e-6)
    return w.astype(np.float32)


WKV_EXTREMES = ["w 0 at chosen steps", "w 1e-30 at chosen steps", "w 1e-30 everywhere",
                "w 1 - 1e-6 everywhere", "w 1e-30 or 1 - 1e-6"]


def _wkv_f64(r, k, v, w, u, S):
    """The WKV time loop in fp64."""
    r, k, v, w, u, S = (t.double() for t in (r, k, v, w, u, S))
    outs = []
    for t in range(r.shape[1]):
        a = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkd->bhd", r[:, t], S + u[None, :, :, None] * a))
        S = w[:, t, :, :, None] * S + a
    return torch.stack(outs, 1), S


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("kind", WKV_EXTREMES)
def test_wkv_chunked_model_extreme_decays(kind, seed):
    """Held to fp64: after a state reset an output r·S can nearly cancel,
    and the fp32 sequential scan is then itself up to 5e-4 off (w 1e-30
    everywhere, seed 3)."""
    r, k, v, w, u, s0 = _wkv((1, 512, 2, 64), seed=seed)
    w = _w_extreme(kind, w, np.random.default_rng(seed))
    args = _port((r, k, v, w, u, s0), WKV_BF)
    out, new = wkv_ops.wkv_chunked_plain(*args)
    assert torch.isfinite(out).all() and torch.isfinite(new).all()
    ref_o, ref_s = _wkv_f64(*args)
    assert rel_err(out, ref_o) <= SCAN_REL
    assert rel_err(new, ref_s) <= SCAN_REL


def _ssm_f64(x, dt, bm, cm, A, h):
    """The selective scan's time loop in fp64."""
    x, dt, bm, cm, A, h = (t.double() for t in (x, dt, bm, cm, A, h))
    dec = torch.exp(A[None, None, :, None] * dt[..., None])
    ys = []
    for t in range(x.shape[1]):
        h = dec[:, t, :, :, None] * h \
            + dt[:, t, :, None, None] * bm[:, t, None, :, None] * x[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnd->bhd", cm[:, t], h))
    return torch.stack(ys, 1), h


SSM_EXTREMES = ["dt 20 at chosen steps", "dt 20 or 1e-3", "dt 20 everywhere"]


def _dt_extreme(kind, dt, rng):
    dt = dt.copy()
    if kind == "dt 20 at chosen steps":
        dt[:, CHOSEN] = 20.0
    elif kind == "dt 20 or 1e-3":
        dt = np.where(rng.random(dt.shape) < 0.3, 20.0, 1e-3)
    else:
        dt[:] = 20.0
    return dt.astype(np.float32)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("kind", SSM_EXTREMES)
def test_ssm_chunked_model_extreme_decays(kind, seed):
    """Held to fp64: an output C_t·B_s can nearly cancel, and the fp32
    sequential scan is then itself up to 1.3e-4 off (dt 20 or 1e-3)."""
    x, dt, bm, cm, A, s0 = _ssm((1, 512, 3, 64, 16), seed=seed)
    dt = _dt_extreme(kind, dt, np.random.default_rng(seed))
    args = _port((x, dt, bm, cm, A, s0), SSM_BF)
    y, new = ssm_ops.ssm_scan_chunked_plain(*args)
    assert torch.isfinite(y).all() and torch.isfinite(new).all()
    ref_y, ref_s = _ssm_f64(*args)
    assert rel_err(y, ref_y) <= SCAN_REL
    assert rel_err(new, ref_s) <= SCAN_REL


def _split(fn, args, at, n_seq=4):
    """fn over steps [0, at) then [at, S), the state carried: (out, state)."""
    s = args[-1]
    parts = []
    for lo, hi in ((0, at), (at, args[0].shape[1])):
        o, s = fn(*(t[:, lo:hi].contiguous() for t in args[:n_seq]), *args[n_seq:-1], s)
        parts.append(o)
    return torch.cat(parts, 1), s


@pytest.mark.parametrize("dh,at", [(64, 256), (64, 128), (32, 192), (128, 224)])
def test_wkv_chunked_model_aligned_splits_bit_equal(dh, at):
    args = _port(_wkv((2, 512, 2, dh), seed=5), WKV_BF)
    assert at % wkv_ops.chunk_len(dh) == 0
    out, new = wkv_ops.wkv_chunked_plain(*args)
    o2, s2 = _split(wkv_ops.wkv_chunked_plain, args, at)
    assert torch.equal(o2, out) and torch.equal(s2, new)


@pytest.mark.parametrize("at", [256, 192, 320])
def test_ssm_chunked_model_aligned_splits_bit_equal(at):
    args = _port(_ssm((2, 512, 3, 64, 16), seed=5), SSM_BF)
    out, new = ssm_ops.ssm_scan_chunked_plain(*args)
    o2, s2 = _split(ssm_ops.ssm_scan_chunked_plain, args, at)
    assert torch.equal(o2, out) and torch.equal(s2, new)


@pytest.mark.parametrize("at", [200, 129, 37])
def test_chunked_models_unaligned_splits_within_scan_rel(at):
    """A split off the chunk grid moves the chunk boundaries: the result
    differs by summation order only."""
    args = _port(_wkv((1, 512, 2, 64), seed=6), WKV_BF)
    out, new = wkv_ops.wkv_chunked_plain(*args)
    o2, s2 = _split(wkv_ops.wkv_chunked_plain, args, at)
    assert rel_err(o2, out) <= SCAN_REL and rel_err(s2, new) <= SCAN_REL
    args = _port(_ssm((1, 512, 3, 64, 16), seed=6), SSM_BF)
    out, new = ssm_ops.ssm_scan_chunked_plain(*args)
    o2, s2 = _split(ssm_ops.ssm_scan_chunked_plain, args, at)
    assert rel_err(o2, out) <= SCAN_REL and rel_err(s2, new) <= SCAN_REL


def test_chunk_fault_is_rejected():
    """chip_smoke.py's planted chunk fault (every chunk's state carried to
    the next without the chunk's decay) lies far outside SCAN_REL, on the
    output and on the final state, for both scans."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    args = _port(_wkv((1, 256, 2, 64), seed=7), WKV_BF)
    good = wkv_ops.wkv_chunked_plain(*args)
    bad = cs.chunk_fault(wkv_ops.wkv_chunked_plain, args, wkv_ops.chunk_len(64), 4)
    assert rel_err(bad[0], good[0]) > 100 * SCAN_REL
    assert rel_err(bad[1], good[1]) > 100 * SCAN_REL
    args = _port(_ssm((1, 256, 3, 64, 16), seed=7), SSM_BF)
    good = ssm_ops.ssm_scan_chunked_plain(*args)
    bad = cs.chunk_fault(ssm_ops.ssm_scan_chunked_plain, args, ssm_ops.CHUNK, 4)
    assert rel_err(bad[0], good[0]) > 100 * SCAN_REL
    assert rel_err(bad[1], good[1]) > 100 * SCAN_REL


# the rule: the served shapes (phase 3c: RWKV6-3B H 40, Hymba-1.5B H 25 /
# N 16, both dh 64), then a grid
@pytest.mark.parametrize("S,dtype,want", [
    (512, bf16, True),            # every prefill of the recurrent serves
    (1, bf16, False),             # every decode step
    (512, torch.float32, False),  # fp32 inputs keep the sequential body
    (127, bf16, False), (128, bf16, True), (1000, bf16, True),
], ids=["prefill", "decode", "f32", "S127", "S128", "S1000"])
def test_chunked_rule_at_the_served_shapes(S, dtype, want):
    assert wkv_ops.takes_chunked(S, dtype, 64) is want
    assert ssm_ops.takes_chunked(S, dtype, 64, 16) is want


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100, 127, 128, 129, 191, 512, 4096])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_chunked_rule_grid(S, dh):
    """bf16 calls of at least two full chunks (128 steps) and nothing else;
    every head size the kernels compile; N 1-64."""
    for N in (1, 8, 16, 64):
        assert ssm_ops.takes_chunked(S, bf16, dh, N) is (S >= 128)
        assert not ssm_ops.takes_chunked(S, torch.float32, dh, N)
    assert wkv_ops.takes_chunked(S, bf16, dh) is (S >= 128)
    assert not wkv_ops.takes_chunked(S, torch.float32, dh)
    assert 2 * wkv_ops.chunk_len(dh) <= wkv_ops.CHUNK_MIN_STEPS


def test_python_rule_is_the_c_rule():
    """The wrappers' rule and chunk lengths are what the C entry points
    dispatch on and the bodies cut their calls by."""
    common = (CSRC / "scan_chunked.cuh").read_text()
    assert int(re.search(r"constexpr int SCAN_CHUNK_MIN_S = (\d+);", common).group(1)) \
        == wkv_ops.CHUNK_MIN_STEPS
    assert int(re.search(r"constexpr int SCAN_SUB = (\d+);", common).group(1)) == wkv_ops.SUB
    m = re.search(r"static constexpr int L = DH == 128 \? (\d+) : (\d+);  // steps per chunk",
                  common)
    assert m and (int(m.group(1)), int(m.group(2))) \
        == (wkv_ops.chunk_len(128), wkv_ops.chunk_len(64)) \
        and wkv_ops.chunk_len(32) == wkv_ops.chunk_len(64)
    m = re.search(r"struct SsmChunkGeom \{\n  static constexpr int L = (\d+);", common)
    assert m and int(m.group(1)) == ssm_ops.CHUNK
    wkv = (CSRC / "wkv_scan.cu").read_text()
    assert re.search(r"return dtype == DTYPE_BF16 && S >= SCAN_CHUNK_MIN_S && "
                     r"\(dh == 32 \|\| dh == 64 \|\| dh == 128\);", wkv)
    assert "if (wkv_takes_chunked(S, dtype, dh)) {" in wkv
    assert wkv_ops.HEAD_DIMS == (32, 64, 128)
    ssm = (CSRC / "ssm_scan.cu").read_text()
    assert re.search(r"return dtype == DTYPE_BF16 && S >= SCAN_CHUNK_MIN_S && "
                     r"\(dh == 32 \|\| dh == 64 \|\| dh == 128\) &&\s+N >= 1 && N <= (\d+);",
                     ssm).group(1) == str(ssm_ops.MAX_STATE)
    assert "if (ssm_takes_chunked(S, dtype, dh, N)) {" in ssm
    # one launch a call: the chunked instantiations keep the profiler's names
    assert "wkv_scan_kernel_chunked" in common and "ssm_scan_kernel_chunked" in common


@pytest.mark.parametrize("name", ["repro_wkv_scan", "repro_ssm_scan"])
def test_scan_entry_points_match_their_signatures(name):
    """Each scan entry point takes as many arguments as its ctypes
    signature passes."""
    src = (CSRC / (name[len("repro_"):] + ".cu")).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m and len(m.group(1).split(",")) == len(build.SIGNATURES[name])


def test_cpu_calls_do_not_count_as_chunked_launches():
    n = (wkv_ops.launches, wkv_ops.chunked_launches, ssm_ops.launches,
         ssm_ops.chunked_launches)
    r, k, v, w, u, s = _port(_wkv((1, 128, 2, 64)), WKV_BF)
    out = wkv_ops.wkv(r, k, v, w, u, s)
    x, dt, bm, cm, A, h = _port(_ssm((1, 128, 2, 64, 16)), SSM_BF)
    y = ssm_ops.ssm_scan(x, dt, bm, cm, A, h)
    assert out.shape == r.shape and y.shape == x.shape
    assert (wkv_ops.launches, wkv_ops.chunked_launches, ssm_ops.launches,
            ssm_ops.chunked_launches) == n


@pytest.mark.parametrize("case", [(2, 300, 3, 64), (1, 1000, 2, 32)],
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}")
def test_wkv_chunked_model_vs_sequential_plain(case):
    """More chunks than a cluster holds (S 1000: 16 chunks, two rounds of
    8) and a ragged last chunk, against the sequential plain version."""
    args = _port(_wkv(case, seed=8), WKV_BF)
    out, new = wkv_ops.wkv_chunked_plain(*args)
    ref_o, ref_s = wkv_ops.wkv_plain(*args)
    assert rel_err(out, ref_o) <= SCAN_REL and rel_err(new, ref_s) <= SCAN_REL


@pytest.mark.parametrize("case", [(2, 300, 3, 64, 16), (1, 1000, 2, 32, 64)],
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}N{c[4]}")
def test_ssm_chunked_model_vs_sequential_plain(case):
    args = _port(_ssm(case, seed=8), SSM_BF)
    y, new = ssm_ops.ssm_scan_chunked_plain(*args)
    ref_y, ref_s = ssm_ops.ssm_scan_plain(*args)
    assert rel_err(y, ref_y) <= SCAN_REL and rel_err(new, ref_s) <= SCAN_REL
