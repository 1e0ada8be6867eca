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
                          decode_inputs, flash_inputs, rel_err, to_torch)
from repro_torch.configs import get_smoke_config
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
