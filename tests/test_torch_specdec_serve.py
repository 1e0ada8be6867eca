"""The single-device backend's speculative serves against the JAX package
on the CPU (split from test_torch_specdec_drafts.py, which keeps the
sampler, the drafts, the provider contract and the prefix-cache spec
serves): greedy serves through the dense path (verify_step) and the paged
one (PagedDecodeCache.verify / commit) for every draft, equal to the
port's non-speculative serve and, under _torch_parity's near-tie rule, to
the JAX package's; a model draft on the target's own weights accepting;
rejection-sampled serves to exact counts, repeated by their seed; and the
launcher's --spec on the single-device path."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same_or_near_tie, port_cfg  # noqa: E402
from repro.serving import EngineBackend as JaxBackend  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.serving import (ContinuousBatchingScheduler,  # noqa: E402
                                 EngineBackend, Request, SamplerConfig,
                                 SchedulerConfig)
from repro_torch.specdec import SpecConfig  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

KINDS = ("ngram", "model", "resident")


@pytest.fixture(scope="module")
def smoke(smoke_model):
    """(JAX cfg, JAX params, the port's cfg, the port's params on the
    CPU): the reduced gemma3-1b of the JAX package's tests, converted."""
    cfg, jp = smoke_model
    return cfg, jp, port_cfg(cfg), params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


# ----------------------------------------------------------------------------
# the backend: speculation on the single-device dense and paged paths
# ----------------------------------------------------------------------------
LENS, NEW = (6, 4), (12, 9)


def _reqs(cls):
    return [cls(i, None, max_new_tokens=n, prompt_len=p)
            for i, (p, n) in enumerate(zip(LENS, NEW))]


def _serve(be, cls=Request):
    done = ContinuousBatchingScheduler(be, SchedulerConfig()).serve(_reqs(cls))
    return [r.output for r in sorted(done, key=lambda r: r.rid)]


@pytest.fixture(scope="module")
def jax_tokens(smoke):
    """The JAX package's EngineBackend, single device, no speculation (its
    own tests hold its spec serves to this)."""
    cfg, jp, _, _ = smoke
    from repro.serving import ContinuousBatchingScheduler as JaxSched
    from repro.serving import SchedulerConfig as JaxSchedCfg
    be = JaxBackend(cfg, jp, n_slots=2, max_len=48)
    done = JaxSched(be, JaxSchedCfg()).serve(_reqs(JaxRequest))
    return [r.output for r in sorted(done, key=lambda r: r.rid)]


def _prompts(vocab):
    return [np.random.default_rng(r).integers(1, vocab, size=n)
            .astype(np.int32) for r, n in enumerate(LENS)]


def _backend(smoke, paged, spec):
    return EngineBackend(smoke[2], smoke[3], n_slots=2, max_len=48,
                         paged=paged, page_size=8, spec=spec, device="cpu")


@pytest.fixture(scope="module")
def plain_tokens(smoke):
    """The port's non-speculative serve on the dense and the paged path,
    the one every draft's serve is held to."""
    return {paged: _serve(_backend(smoke, paged, None))
            for paged in (False, True)}


@pytest.mark.parametrize("draft", KINDS)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_serve_lossless_single_device(paged, draft, smoke, jax_tokens,
                                           plain_tokens):
    """Greedy speculative serves equal the port's non-speculative serve
    token for token, and the JAX package's (near-tie rule), through the
    dense path (verify_step) and the paged one (PagedDecodeCache.verify /
    commit), for every draft (JAX's
    test_engine_backend_spec_lossless_single_device)."""
    cfg, jp, pcfg, pp = smoke
    be = _backend(smoke, paged, SpecConfig(k=3, draft=draft))
    got = _serve(be)
    assert got == plain_tokens[paged]
    assert_same_or_near_tie(cfg, jp, pp, _prompts(cfg.vocab_size), got,
                            jax_tokens, 48, width=max(LENS))
    st = be.spec_stats
    assert st["spec_rounds"] > 0 and 0 <= st["spec_accepted"] <= \
        st["spec_drafted"]
    assert all(1 <= c <= k + 1 for k, c in be.rounds if k)
    if paged:
        pc = be._paged_cache
        assert pc.pages_in_use == sum(-(-pc.pos // 8) for _ in pc.tables)


def test_model_draft_on_the_targets_weights_accepts(smoke):
    """A model draft that shares the target's weights (the same smoke
    config, the same seed) accepts drafts and commits k + 1 in a round:
    the accept path end to end (JAX's
    test_engine_backend_spec_model_draft_accepts)."""
    pcfg = smoke[2]
    pp = PM.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")

    def run(spec):
        be = EngineBackend(pcfg, pp, n_slots=1, max_len=48, spec=spec,
                           device="cpu")
        done = ContinuousBatchingScheduler(be, SchedulerConfig()).serve(
            [Request(0, None, max_new_tokens=12, prompt_len=6)])
        return done[0].output, be
    base, _ = run(None)
    out, be = run(SpecConfig(k=3, draft="model", draft_arch="gemma3-1b"))
    assert out == base
    assert be.spec_stats["spec_accepted"] > 0
    assert (3, 4) in be.rounds


@pytest.mark.parametrize("draft", ["ngram", "model"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_serve_stochastic_exact_counts(paged, draft, smoke):
    """Temperature 0.8 / top-p 0.95: rejection sampling drives the serve
    to exact per-request counts of in-vocabulary tokens, and a seed
    repeats it (JAX's test_engine_backend_spec_stochastic_counts)."""
    _, _, pcfg, pp = smoke
    outs = []
    for _ in range(2):
        be = EngineBackend(pcfg, pp, n_slots=2, max_len=48, paged=paged,
                           page_size=8,
                           sampler=SamplerConfig(temperature=0.8, top_p=0.95,
                                                 seed=3),
                           spec=SpecConfig(k=3, draft=draft, seed=7,
                                           draft_temperature=0.8),
                           device="cpu")
        done = ContinuousBatchingScheduler(be, SchedulerConfig()).serve(
            _reqs(Request))
        by = {r.rid: r for r in done}
        for rid, n in enumerate(NEW):
            assert by[rid].generated == n and len(by[rid].output) == n
        assert all(0 <= t < pcfg.vocab_size for r in done for t in r.output)
        assert be.spec_stats["spec_rounds"] > 0
        outs.append([by[i].output for i in range(2)])
    assert outs[0] == outs[1]


def test_launcher_spec_ngram_without_engine(capsys):
    """--spec --spec-draft ngram on the single-device path: the report
    counts speculative rounds."""
    rc = launch_serve.main(["--arch", "gemma3-1b", "--smoke", "--device",
                            "cpu", "--spec", "--spec-draft", "ngram",
                            "--spec-k", "3", "--pattern", "bursty",
                            "--requests", "4", "--max-new", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["backend"] == "fallback" and report["total_tokens"] == 24
    assert report["spec_rounds"] > 0 and report["spec_drafted"] > 0
