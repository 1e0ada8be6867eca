"""The port's serving stack against the JAX package's, greedy, on the same
converted weights and the same prompts: LimeServer -> scheduler ->
single-device backend on both sides must emit the same tokens (outside
near ties, judged by the rule in _torch_parity). Also drives the port's
launcher on the CPU."""
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import LOGIT_TOL, f32, jax_params, margin, port_cfg  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import LimeServer as JaxServer  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.serving import LimeServer  # noqa: E402

MAX_LEN, MAX_NEW = 32, 6


def _logits_along(cfg, jp, pp, prompt, tokens):
    """Reference and port logits (T, V) of one left-padded prompt followed
    by `tokens` (teacher-forced)."""
    pcfg = port_cfg(cfg)
    toks = np.asarray(prompt, np.int32)[None]
    jl, jc = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks), JM.init_cache(cfg, 1, MAX_LEN))
    pl, pc = PM.prefill(pcfg, pp, torch.from_numpy(toks).long(),
                        PM.init_cache(pcfg, 1, MAX_LEN, device="cpu"))
    jd = jax.jit(functools.partial(JM.decode_step, cfg))
    a, b = [f32(jl)[0, -1]], [f32(pl)[0, -1]]
    for t in tokens:
        jl, jc = jd(jp, jc, jnp.asarray([[t]], jnp.int32))
        pl, pc = PM.decode_step(pcfg, pp, pc, torch.tensor([[t]]))
        a.append(f32(jl)[0, -1])
        b.append(f32(pl)[0, -1])
    v = cfg.vocab_size
    return np.stack(a)[:, :v], np.stack(b)[:, :v]


@pytest.mark.parametrize("arch,pattern,lens", [
    ("tiny", "sporadic", [8, 8]),
    ("tiny", "bursty", [8, 5, 8, 3]),        # uneven: left-padding with 0
    ("gemma3-1b", "bursty", [10, 10, 7, 10]),
])
def test_lime_server_token_identical(arch, pattern, lens, tiny_dense_factory):
    cfg = tiny_dense_factory() if arch == "tiny" else get_smoke_config(arch)
    jp, _, pp = jax_params(cfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    jsrv = JaxServer(cfg, jp, max_len=MAX_LEN, pattern=pattern)
    psrv = LimeServer(port_cfg(cfg), pp, max_len=MAX_LEN, pattern=pattern,
                      device="cpu")
    for srv in (jsrv, psrv):
        for p in prompts:
            srv.queue.submit(p, MAX_NEW)
    ref = sorted(jsrv.serve_all(), key=lambda r: r.rid)
    got = sorted(psrv.serve_all(), key=lambda r: r.rid)
    assert [r.rid for r in got] == [r.rid for r in ref]
    width = max(lens) if pattern == "bursty" else None
    for p, a, b in zip(prompts, got, ref):
        assert not a.rejected and len(a.output) == MAX_NEW
        if a.output == b.output:
            continue
        # first divergence must be a near tie of the reference
        t = next(i for i, (x, y) in enumerate(zip(a.output, b.output))
                 if x != y)
        padded = p if width is None else np.pad(p, (width - len(p), 0))
        la, lb = _logits_along(cfg, jp, pp, padded, b.output[:t])
        assert margin(la[t:t + 1])[0] < LOGIT_TOL, \
            f"req {b.rid}: token {t} diverges outside a near tie"
        np.testing.assert_allclose(lb[t], la[t], atol=LOGIT_TOL)


def test_launcher_prints_report(capsys):
    rc = launch_serve.main(["--arch", "gemma3-1b", "--smoke", "--device",
                            "cpu", "--pattern", "bursty", "--requests", "4",
                            "--max-new", "3", "--prompt-len", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert sum(line.startswith("req ") for line in lines) == 4
    report = json.loads(out[out.index("{"):])
    assert report["n_requests"] == 4 and report["total_tokens"] == 12
    assert report["backend"] == "fallback" and report["pattern"] == "bursty"
