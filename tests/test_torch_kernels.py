"""The port's attention kernels' functions against the JAX package.

The multi-query (speculative verify / chunked prefill) plain version is
held to BF16_REL of each output head vector's largest |ref| (the limit the
card holds the kernel to), against the interpret-mode Pallas kernel and the
jnp oracle, on every row that sees a slot. A row that sees none outputs 0
in the port, as its decode and flash kernels do; both JAX versions give
the uniform average of V there (their masked scores all equal NEG_INF, so
exp(s - max) is 1). No served row sees nothing: a query sees its own slot.

On the CPU each wrapper takes its plain PyTorch version; here both are
held against the JAX package's jnp oracles and its Pallas kernels run in
interpret mode, over the case lists of tests/test_kernels.py. Tolerances
are that file's: 0.04 in bf16 (a few bf16 ulps of outputs of N(0,1)
inputs, where the two sides round probabilities at different points) and
2e-5 in fp32 (summation order only). Inputs come from numpy and are handed
to both sides. The CUDA kernels themselves run only on the card:
tests/test_torch_gpu.py holds them against these plain versions there.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as jax_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.decode_attention import multiquery as jax_mq  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro.models.attention import mq_decode_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels.decode_attention import multiquery as mq  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402

from _torch_cases import (BF16_REL, BF16_TOL, DECODE_CASES,  # noqa: E402
                          F32_TOL, FLASH_CASES, MQ_CASES, TORCH_DT,
                          decode_inputs, f32, flash_inputs, mq_inputs,
                          np_rand, rel_err, to_torch)
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}kv{c[4]}d{c[5]}")
def test_flash_plain_vs_jax(case):
    B, Sq, Skv, H, KV, dh, causal, window, dt = case
    q, k, v = flash_inputs(case)
    n0 = fa.launches
    out = fa.flash_attention(to_torch(q, dt), to_torch(k, dt),
                             to_torch(v, dt), causal=causal, window=window)
    assert fa.launches == n0, "a CPU tensor must never launch the kernel"
    assert out.dtype == TORCH_DT[dt] and out.shape == (B, Sq, H, dh)
    tol = BF16_TOL if dt == "bf16" else F32_TOL
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    pal = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=32,
                    block_k=32, interpret=True)
    np.testing.assert_allclose(f32(out), f32(ref), atol=tol)
    np.testing.assert_allclose(f32(out), f32(pal), atol=tol)


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"S{c[1]}H{c[2]}kv{c[3]}p{c[5]}{'r' if c[7] else ''}")
def test_decode_plain_vs_jax(case):
    B, S_c, H, KV, dh, pos, window, ring = case
    q, k, v, ids = decode_inputs(case)
    n0 = da.launches
    out = da.decode_attention(to_torch(q, "bf16"), to_torch(k, "bf16"),
                              to_torch(v, "bf16"), torch.from_numpy(ids), pos,
                              window=window)
    assert da.launches == n0, "a CPU tensor must never launch the kernel"
    assert out.dtype == torch.bfloat16 and out.shape == (B, 1, H, dh)
    jq, jk, jv, jids = map(jnp.asarray, (q, k, v, ids))
    ref = decode_attention_ref(jq, jk, jv, jids, jnp.int32(pos), window=window)
    pal = jax_decode(jq, jk, jv, jids, jnp.int32(pos), window=window,
                     block_k=32, interpret=True)
    np.testing.assert_allclose(f32(out), f32(ref), atol=BF16_TOL)
    np.testing.assert_allclose(f32(out), f32(pal), atol=BF16_TOL)


def test_fully_masked_rows_output_zero():
    """The kernels' contract for a query that sees no key (l == 0 -> 1):
    zeros, in both plain versions."""
    rng = np.random.default_rng(3)
    q, k, v = (to_torch(np_rand(rng, s, "f32"), "f32")
               for s in ((1, 4, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16)))
    # causal with a negative offset: the first query rows precede every key
    out = fa.flash_attention_plain(q, k, v, causal=True, q_offset=-2)
    assert torch.count_nonzero(out[0, :2]) == 0
    assert torch.count_nonzero(out[0, 2:]) > 0
    ids = torch.full((8,), -1, dtype=torch.int32)
    out = da.decode_attention_plain(q[:, :1], k, v, ids, 5)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("case", MQ_CASES,
                         ids=lambda c: f"q{c[1]}S{c[2]}H{c[3]}kv{c[4]}d{c[5]}p{c[6]}-{c[8]}")
def test_mq_plain_vs_jax(case):
    B, Q, S_c, H, KV, dh, pos, window, kind = case
    q, k, v, ids = mq_inputs(case)
    n0 = mq.launches
    out = mq.mq_decode_attention(to_torch(q, "bf16"), to_torch(k, "bf16"),
                                 to_torch(v, "bf16"), torch.from_numpy(ids),
                                 pos, window=window)
    assert mq.launches == n0, "a CPU tensor must never launch the kernel"
    assert out.dtype == torch.bfloat16 and out.shape == (B, Q, H, dh)
    jq, jk, jv, jids = map(jnp.asarray, (q, k, v, ids))
    pal = jax_mq.mq_decode_attention(jq, jk, jv, jids, jnp.int32(pos),
                                     window=window, block_k=32,
                                     interpret=True)
    ref = mq_decode_attention_ref(jq, jk, jv, jids, jnp.int32(pos),
                                  window=window)
    pal, ref = (torch.from_numpy(f32(a)) for a in (pal, ref))
    qpos = pos + np.arange(Q)[:, None]
    seen = ((ids >= 0) & (ids <= qpos)
            & (qpos - ids < (window or 2 ** 30))).any(-1)          # (Q,)
    if seen.any():
        assert rel_err(out[:, seen], pal[:, seen]) <= BF16_REL
        assert rel_err(out[:, seen], ref[:, seen]) <= BF16_REL
    assert torch.count_nonzero(out[:, ~seen]) == 0
    assert seen.all() == (kind not in ("masked", "first-masked"))


@pytest.mark.parametrize("case", [c for c in DECODE_CASES],
                         ids=lambda c: f"S{c[1]}H{c[2]}kv{c[3]}p{c[5]}{'r' if c[7] else ''}")
def test_mq_plain_at_qlen1_is_decode_plain(case):
    """At q_len 1 the multi-query function is the one-token decode: the
    plain versions agree within BF16_REL (the JAX package's bit-exact
    version of this contract cannot cross compilers)."""
    B, S_c, H, KV, dh, pos, window, ring = case
    q, k, v, ids = (torch.from_numpy(np.asarray(a, np.float32))
                    for a in decode_inputs(case))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    ids = ids.int()
    a = mq.mq_decode_attention_plain(q, k, v, ids, pos, window=window)
    b = da.decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(a, b) <= BF16_REL
