"""The port's serving stack against the JAX package's, greedy, on the same
converted weights and the same prompts: LimeServer -> scheduler ->
single-device backend on both sides must emit the same tokens (outside
near ties, judged by the rule in _torch_parity). Also drives the port's
launcher on the CPU."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import (assert_same_or_near_tie, jax_params,  # noqa: E402
                           port_cfg)
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.serving.server import LimeServer as JaxServer  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serving import LimeServer  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

MAX_LEN, MAX_NEW = 32, 6


@pytest.mark.parametrize("arch,pattern,lens", [
    ("tiny", "sporadic", [8, 8]),
    ("tiny", "bursty", [8, 5, 8, 3]),        # uneven: left-padding with 0
    ("gemma3-1b", "bursty", [10, 10, 7, 10]),
    ("stablelm-12b", "bursty", [8, 5, 8, 3]),   # parallel blocks
    ("pixtral-12b", "bursty", [8, 5, 8, 3]),    # the VLM, text prompts
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
    for a in got:
        assert not a.rejected and len(a.output) == MAX_NEW
    assert_same_or_near_tie(cfg, jp, pp, prompts, [r.output for r in got],
                            [r.output for r in ref], MAX_LEN, width)


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
