"""The port's CUDA kernels and main path on the card.

Marked `gpu`: each test decides inside a fixture whether a CUDA device is
visible and skips without one (the kernels are CUDA C++ with no CPU
mode). Imports no JAX, so it runs on the card's machine, where
tests/conftest.py (which imports JAX) is skipped:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_cases import (BF16_REL, DECODE_CASES, F32_REL, FLASH_CASES,
                          MQ_CASES, decode_inputs, flash_inputs, mq_inputs,
                          rel_err, to_torch)
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import InterleavedEngine, UniformPlan
from repro_torch.kernels.decode_attention import multiquery as mq
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import model as M
from repro_torch.serving import LimeServer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}kv{c[4]}d{c[5]}")
def test_flash_kernel_vs_plain(case, cuda_device):
    B, Sq, Skv, H, KV, dh, causal, window, dt = case
    q, k, v = (to_torch(a, dt, cuda_device) for a in flash_inputs(case))
    n0 = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert rel_err(out, ref) <= (BF16_REL if dt == "bf16" else F32_REL)


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"S{c[1]}H{c[2]}kv{c[3]}p{c[5]}{'r' if c[7] else ''}")
def test_decode_kernel_vs_plain(case, cuda_device):
    B, S_c, H, KV, dh, pos, window, ring = case
    q, k, v, ids = decode_inputs(case)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = da.launches
    out = da.decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert da.launches == n0 + 1
    ref = da.decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", MQ_CASES,
                         ids=lambda c: f"q{c[1]}S{c[2]}H{c[3]}kv{c[4]}d{c[5]}p{c[6]}-{c[8]}")
def test_mq_kernel_vs_plain(case, cuda_device):
    B, Q, S_c, H, KV, dh, pos, window, kind = case
    q, k, v, ids = mq_inputs(case)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = mq.launches
    out = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert mq.launches == n0 + 1
    ref = mq.mq_decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL
    if kind == "masked":
        assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("q_len,pos", [(5, 1019), (512, 0)],
                         ids=["verify", "prefill"])
def test_mq_kernel_main_shapes(q_len, pos, cuda_device):
    """The main path's shapes: verify (k = 4) at the end of a full cache,
    and a 512-position prefill round into an empty one."""
    case = (4, q_len, 1024, 64, 8, 128, pos, None, "linear")
    q, k, v, ids = mq_inputs(case, seed=1)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    out = mq.mq_decode_attention(q, k, v, ids, pos)
    ref = mq.mq_decode_attention_plain(q, k, v, ids, pos)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"S{c[1]}H{c[2]}kv{c[3]}p{c[5]}{'r' if c[7] else ''}")
def test_mq_kernel_at_qlen1_is_decode_kernel(case, cuda_device):
    B, S_c, H, KV, dh, pos, window, ring = case
    q, k, v, ids = decode_inputs(case)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    a = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    b = da.decode_attention(q, k, v, ids, pos, window=window)
    assert rel_err(a, b) <= BF16_REL


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 1, 4, 64), dtype=torch.float16, device=cuda_device)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.float16, device=cuda_device)
    ids = torch.arange(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        da.decode_attention(q, k, k, ids, 7)
    q = torch.zeros((1, 16, 4, 512), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., ::2], q[..., ::2], q[..., ::2])
    qf = torch.zeros((1, 2, 4, 64), dtype=torch.float32, device=cuda_device)
    kf = torch.zeros((1, 8, 2, 64), dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):          # the mq kernel is bf16 only
        mq.mq_decode_attention(qf, kf, kf, ids, 7)
    with pytest.raises(ValueError):
        mq.mq_decode_attention(qf.bfloat16(), kf.bfloat16(), kf.bfloat16(),
                               ids[:4], 7)


def test_model_kernel_path_vs_reference(cuda_device):
    """gemma3 smoke (sliding windows, a ring that wraps) on the card:
    the kernel path launches both kernels and its logits stay within
    bf16 noise of the reference math."""
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"), window_size=6)
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    out, fed = {}, []
    for impl in ("ref", "kernel"):        # kernel path fed the ref's picks
        f0, d0 = fa.launches, da.launches
        cache = M.init_cache(cfg, 2, 16)
        lg, cache = M.prefill(cfg, params, toks.to(cuda_device), cache,
                              impl=impl)
        steps = [lg[:, -1].float()]
        for i in range(8):
            if impl == "ref":
                fed.append(lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True))
            lg, cache = M.decode_step(cfg, params, cache, fed[i], impl=impl)
            steps.append(lg[:, -1].float())
        out[impl] = torch.stack(steps)
        launched = (fa.launches - f0, da.launches - d0)
        assert launched == ((cfg.n_layers, 8 * cfg.n_layers)
                            if impl == "kernel" else (0, 0))
    err = (out["kernel"] - out["ref"]).abs().max().item()
    assert err <= 0.05 * out["ref"].abs().max().item()


def test_lime_server_defaults_to_the_card(cuda_device):
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg)           # no device: the card
    assert params["embedding"].device.type == "cuda"
    srv = LimeServer(cfg, params, max_len=64, pattern="bursty")
    rng = np.random.default_rng(0)
    for _ in range(4):
        srv.queue.submit(rng.integers(1, cfg.vocab_size, 12), 5)
    n0 = da.launches
    done = srv.serve_all()
    assert len(done) == 4 and all(len(r.output) == 5 for r in done)
    assert da.launches - n0 == 4 * cfg.n_layers


def test_engine_streams_and_matches_model(cuda_device):
    """llama smoke, 4 layers, 2 chunks of 1 resident + 1 streamed layer
    (pinned host store, side-stream copies): decode and verify equal the
    model's kernel path bit for bit, and a retier round trip keeps them
    equal."""
    cfg = dataclasses.replace(get_smoke_config("llama3.3-70b"), n_layers=4)
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    eng = InterleavedEngine(cfg, UniformPlan(1, 2, 1, 1), mb=2, max_len=32,
                            retier_headroom=1)
    st = eng.init_state(params)
    assert eng._store.registered and eng._store.data.is_pinned()
    mc = M.init_cache(cfg, 2, 32)
    toks = torch.randint(1, cfg.vocab_size, (2, 9), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    m0 = mq.launches
    el, st = eng.verify_step(st, toks)
    ml, mc = M.verify_step(cfg, params, mc, toks, impl="kernel")
    assert mq.launches - m0 == 2 * cfg.n_layers
    assert torch.equal(el, ml)
    tok = el[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for step in range(4):
        if step == 1:
            eng.retier(st, 0, +1)
        if step == 3:
            eng.retier(st, 0, -1)
        el, st = eng.decode_step(st, tok)
        ml, mc = M.decode_step(cfg, params, mc, tok, impl="kernel")
        assert torch.equal(el, ml[:, 0])
        tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    eng.close()
