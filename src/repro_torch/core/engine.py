"""LIME's interleaved offload engine on one CUDA device (counterpart of
``repro.core.engine``).

The paper's mechanism on an H100: a model too large for HBM runs as
C = n_seg chunks of contiguous layers; chunk c runs its k_res resident
layers from HBM, then its k_off streamed layers, each copied from pinned
host memory (the paper's SSD; its read bandwidth is PCIe here) into one of
two one-layer device buffers on a side CUDA stream. The copy of streamed
layer j+1 is issued before layer j computes, and the first streamed layer
of a chunk is fetched while the chunk's resident layers compute: the
paper's interleave. A copy waits on the compute stream's "buffer free"
event for its buffer, compute waits on the copy's "copy done" event.

Families: dense, MoE, SSM (RWKV6), hybrid (Hymba) and encoder-decoder
(SeamlessM4T), each layer run by the model's own per-layer bodies
(``M.step_layer`` in a pass, ``M.prefill_layer`` in the prompt pass over
the tiers); the VLM (whose patch embeddings only M.prefill takes) is
refused as the JAX engine's paths refuse it. The encoder-decoder family's
encoder runs outside the tiers, as in the JAX engine (``enc_len``): its
weights are shared and resident (``encode``); each decoder layer's cross
K/V (``xk`` / ``xv``, state beside K/V) come from that layer's own
weights in the prompt pass (``prefill(tokens, enc_out=)``), and every
pass cross-attends to the first enc_len frames. An MoE stack must be
homogeneous, as the JAX engine asserts: a config with dense first layers
is refused, and runs folded (``dataclasses.replace(cfg,
first_dense_layers=0)``: every layer an MoE layer). Each MoE layer routes
the mb rows of a pass (mb · q_len in a verify round) as one batch of
tokens, finished slots included, as the JAX engine's micro-batch does.
Chunked prefill, verification and the resident self-draft need pure-KV
per-layer state (the dense and MoE families), as in the JAX package; the
recurrent and encoder-decoder families prefill through ``prefill`` (the
prompt pass over the tiers) and ``seed_cache``.

Of the JAX package's two streaming designs this is fetch_mode="slot"
(each streamed layer fetched when its chunk runs) on one stage; the
multi-stage ring (n_stage > 1) and fetch_mode="step" (every streamed
layer restored once a step: on one stage that would hold them all in HBM)
are not ported. Also ported: ``long_mode`` (windowed globals, a
window-sized ring) and the paged slot accounting (``paged=``: block tables
over a PagePool, ``seed_cache`` moving K/V through the pages, extended per
decode step and per committed spec round, freed on release; the cross
K/V stay contiguous). One position is shared by every slot, as in the JAX
engine.

Placement: ``plan_layout`` / ``split_layer_stack`` give the JAX package's
index maps for every plan whose resident count divides its segments. Where
it does not (Alg. 1's 39 resident layers over 41 segments), the JAX grid
rounds every chunk up to ceil(resident / n_seg) residents; the port lays
out exactly the plan's resident count, one more in the first chunks, so
the engine runs the plan the cost model priced. Resident layers live in HBM,
one flat bf16 tensor each (a leaf of another dtype, the MoE router's fp32,
packed bit for bit as a view of the same bytes); streamed layers in a
pinned host store of
n_seg x (retier_headroom + k_off) one-layer slots. Pinned memory is plain
host memory registered with cudaHostRegister: PyTorch's pinned allocator
rounds each block up to a power of two (a 1.71 GB layer would take 2 GiB).

The cache stays in HBM in the model's layout (K/V (L, B, S_c, KV, dh),
the recurrent states (L, B, ...), the cross K/V (L, B, S_enc, KV, dh)),
indexed by real layer id whichever tier
holds the layer, so ``retier`` moves weights only: unlike the JAX
package's per-stage grid (where a demoted layer's cache rows move with
it) no cache row moves. The engine state *is* the model's cache dict, so
engine and model steps run on the same state; the weights belong to the
engine (``init_state`` loads them once from a layer source).

Every pass (decode, verify, the rounds of ``prefill_partial``, the prompt
pass, the resident-only draft step) takes ``steps=`` (a
``core.capture.CapturedStep``) and then replays one CUDA graph per shape,
the counterpart of the JAX engine's jitted pass: the pass forks the copy
stream from the capture stream (both buffers marked free there) and joins
it before the pass ends, so the copies, the events between them and the
layers' compute become graph nodes and the interleave their dependencies.
A graph reads the pinned store and the resident layers at their
addresses: every weight load and retier bumps ``layout_version``, which
the graphs' scope holds, so the next pass captures again.
"""
from __future__ import annotations

import math
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.core import capture
from repro_torch.core.capture import CapturedStep
from repro_torch.core.cost_model import ExecutionPlan
from repro_torch.device import resolve_device
from repro_torch.kvcache.allocator import BlockTable
from repro_torch.kvcache.layout import gather_from_pages, scatter_to_pages
from repro_torch.kvcache.pool import PagedKVConfig, PagePool
from repro_torch.models import model as M
from repro_torch.models.modules import rms_norm, round_up, unembed

# the families whose layers the engine streams; of them the dense and MoE
# families have pure-KV per-layer state (chunked prefill, verify, draft)
FAMILIES = (Family.DENSE, Family.MOE, Family.SSM, Family.HYBRID,
            Family.ENCDEC)
# the JAX engine's words for a stack that is not homogeneous
HOMOGENEOUS = ("engine expects a homogeneous stack; fold dense layers via "
               "configs with first_dense_layers=0 or pad (see tests)")


def UniformPlan(n_stage: int, n_seg: int, k_res: int,
                k_off: int) -> ExecutionPlan:
    return ExecutionPlan.uniform(n_stage, n_seg, k_res, k_off)


def plan_for(cfg: ModelConfig, n_stage: int, *, hbm_frac_for_weights: float,
             hbm_bytes: float = 16e9) -> ExecutionPlan:
    """Pick (n_seg, k_res, k_off) so resident weights fit the per-stage
    budget hbm_bytes · hbm_frac_for_weights (the JAX package's rule, same
    plan for the same inputs): everything resident when it fits, else the
    fewest segments whose chunk keeps at least one resident layer, else a
    2-segment plan sized by the budget."""
    budget = hbm_bytes * hbm_frac_for_weights
    l_bytes = cfg.layer_params() * 2
    total_per_stage = cfg.n_layers / n_stage * l_bytes
    if total_per_stage <= budget:
        return UniformPlan(n_stage, 1, math.ceil(cfg.n_layers / n_stage), 0)
    res_layers = int(budget // l_bytes) * n_stage
    off_layers = cfg.n_layers - res_layers
    for n_seg in range(2, max(3, cfg.n_layers // n_stage + 1)):
        c = n_seg * n_stage
        if cfg.n_layers % c:
            continue
        k = cfg.n_layers // c
        k_off = max(math.ceil(off_layers / c), 1)
        if k_off < k:
            return UniformPlan(n_stage, n_seg, k - k_off, k_off)
    c = 2 * n_stage
    k = math.ceil(cfg.n_layers / c)
    k_res = max(min(int(budget // l_bytes) // 2, k - 1), 0)
    return UniformPlan(n_stage, 2, k_res, k - k_res)


def weight_budget(cfg: ModelConfig, *, batch: int, max_len: int,
                  free_bytes: float) -> float:
    """HBM left for resident layers out of free_bytes: less the model's
    cache for `batch` sequences (K/V at S_c slots, bf16; the recurrent
    states), the two one-layer load buffers (the engine's packed layer)
    and the shared weights (embedding, lm_head, final norm)."""
    cache = M.init_cache(cfg, batch, max_len, device="meta")
    state = sum(t.numel() * t.element_size() for k, t in cache.items()
                if k not in ("pos", "pos_ids"))
    pv = round_up(cfg.vocab_size, 256)
    shared = (pv * cfg.d_model * (1 if cfg.tie_embeddings else 2)
              + cfg.d_model) * 2
    return free_bytes - state - 2 * packed_layer_bytes(cfg) - shared


Slot = Tuple[Tuple[str, ...], tuple, torch.dtype, int]


def _layer_slots(cfg: ModelConfig) -> Tuple[List[Slot], int]:
    """The flat packing of one layer of cfg's family: every leaf at a
    256-byte aligned offset of one bf16 tensor (one H2D copy per streamed
    layer), a leaf of a wider dtype (the MoE router's fp32) taking as many
    bf16 elements as its bytes fill. Returns ([(path, shape, dtype,
    offset)], numel), offsets and numel in bf16 elements."""
    slots, off = [], 0
    for path, shape, dtype in _leaves(M._LAYER_SPECS[cfg.family](cfg)):
        slots.append((path, shape, dtype, off))
        units = math.prod(shape) * dtype.itemsize // 2
        off += -(-units // 128) * 128
    return slots, off


def packed_layer_bytes(cfg: ModelConfig) -> int:
    """Bytes of one packed layer: what a resident layer holds in HBM and a
    streamed one copies per pass. cfg.layer_params() (the reference's
    count, which plan_for and the cost model price) misjudges the
    recurrent layers (an RWKV6-3B layer packs 85.6 M parameters against
    its 81.9 M) and counts an MoE layer's fp32 router at bf16's width."""
    return _layer_slots(cfg)[1] * 2


def plan_layout(plan: ExecutionPlan, headroom: int = 0, k_res_live=None):
    """Index maps from the flat layer stack into the padded per-stage grid:
    (res_ids (n_seg, n_stage, k_res_cap), off_ids (n_seg, n_stage,
    headroom + k_off_cap)) of flat layer ids, or plan.n_layers for a dead
    slot. Chunk c = s·n_stage + d holds its resident layers (k_res_d, or
    k_res_d - 1 in the last segments when stage d's resident_total does
    not divide n_seg: exactly resident_total in all), then its streamed
    tail. With k_res_live (per stage, <= k_res_d) the demoted resident
    slot j moves its layer into headroom slot headroom - (k_res_d - j):
    demotions fill the headroom right to left, so the streamed tier keeps
    layer order."""
    kr, ko = plan.k_res_list, plan.k_off_list
    n_seg, S = plan.n_seg, plan.n_stage
    kr_cap = max(kr) if kr else 0
    ko_cap = headroom + (max(ko) if ko else 0)
    live = list(kr) if k_res_live is None else [int(x) for x in k_res_live]
    assert all(0 <= lv <= k and k - lv <= headroom
               for lv, k in zip(live, kr)), (live, kr, headroom)
    dead = plan.n_layers
    res_ids = np.full((n_seg, S, max(kr_cap, 1)), dead, np.int32)
    off_ids = np.full((n_seg, S, max(ko_cap, 1)), dead, np.int32)
    # segments that hold k_res_d residents; the rest hold one fewer
    full = [st.resident_total - n_seg * (k - 1) if k else n_seg
            for st, k in zip(plan.stages, kr)]
    flat = 0
    for c in range(n_seg * S):
        s, d = c // S, c % S
        n_res = kr[d] if s < full[d] else kr[d] - 1
        for j in range(n_res):
            if j < live[d]:
                res_ids[s, d, j] = flat + j
            else:
                off_ids[s, d, headroom - (kr[d] - j)] = flat + j
        for j in range(ko[d]):
            off_ids[s, d, headroom + j] = flat + n_res + j
        flat += n_res + ko[d]
    return res_ids[:, :, :kr_cap], off_ids[:, :, :ko_cap]


def split_layer_stack(stacked: dict, plan: ExecutionPlan, *,
                      headroom: int = 0, k_res_live=None):
    """(L, ...) tree -> (resident (n_seg, n_stage, k_res_cap, ...),
    offloaded (n_seg, n_stage, headroom + k_off_cap, ...)) by plan_layout;
    dead slots are zero (identity) layers."""
    res_ids, off_ids = plan_layout(plan, headroom, k_res_live)
    res_ix = torch.from_numpy(res_ids).long()
    off_ix = torch.from_numpy(off_ids).long()

    def do(t):
        if isinstance(t, dict):
            pairs = {k: do(v) for k, v in t.items()}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        pad = plan.n_layers + 1 - t.shape[0]
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))]) \
            if pad > 0 else t
        return t[res_ix], t[off_ix]
    return do(stacked)


def _leaves(specs: dict, prefix=()):
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape), v.dtype


def _to(dev: torch.device, t):
    """A tree of tensors (the shared weights, an encoder stack among them)
    on dev."""
    return {k: _to(dev, v) for k, v in t.items()} if isinstance(t, dict) \
        else t.to(dev)


def _mem_available_bytes() -> Optional[int]:
    try:
        for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class PinnedStore:
    """A bf16 host tensor of `shape`; on a CUDA engine registered with
    cudaHostRegister (page-locked, so the side stream's H2D copies run
    asynchronously at the link's rate) and unregistered by close()."""

    def __init__(self, shape: Tuple[int, ...], device: torch.device):
        need = math.prod(shape) * 2
        avail = _mem_available_bytes()
        if device.type == "cuda" and avail is not None and need > avail:
            raise MemoryError(
                f"the streamed tier needs {need / 1e9:.2f} GB of pinned host "
                f"memory; MemAvailable is {avail / 1e9:.2f} GB")
        self.data = torch.empty(shape, dtype=torch.bfloat16)
        self.registered = False
        if device.type == "cuda" and self.data.numel():
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                self.data.data_ptr(), need, 0))
            self.registered = True
        # whether torch sees it as page-locked: only then is a
        # copy_(non_blocking=True) from it an asynchronous copy that a
        # CUDA graph can hold
        self.pinned = self.registered and self.data.is_pinned()

    @property
    def nbytes(self) -> int:
        return self.data.numel() * 2

    def close(self) -> None:
        if self.registered:
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(
                self.data.data_ptr()))
            self.registered = False
        self.data = self.data.new_empty((0,))


class _Streamer:
    """Two one-layer device buffers fed from the pinned store on a side
    stream. begin() forks the side stream from the compute stream (both
    buffers free as of the work enqueued so far); fetch(i, src) fills
    buffer i once the compute stream has released it; acquire(i) makes
    the compute stream wait for that copy; release(i) marks the buffer
    free after the work enqueued so far; end() joins the side stream back.
    Every event a pass waits on is recorded in that pass, so a captured
    pass holds no event of an earlier one (a wait on it is illegal in a
    capture; replays on one stream run in order). On the CPU the copy is
    immediate and the events are no-ops."""

    def __init__(self, numel: int, device: torch.device,
                 pinned: bool = False):
        self.bufs = [torch.zeros(numel, dtype=torch.bfloat16, device=device)
                     for _ in range(2)]
        self.cuda = device.type == "cuda"
        self.pinned = pinned      # the store is page-locked in torch's eyes
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.done = [torch.cuda.Event() for _ in range(2)]
            self.free = [torch.cuda.Event() for _ in range(2)]

    def begin(self) -> None:
        if self.cuda:
            cur = torch.cuda.current_stream()
            for ev in self.free:
                ev.record(cur)

    def end(self) -> None:
        if self.cuda:
            torch.cuda.current_stream().wait_stream(self.stream)

    def fetch(self, i: int, src: torch.Tensor) -> None:
        if not self.cuda:
            self.bufs[i].copy_(src)
            return
        if not self.pinned and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a captured pass copies streamed layers from "
                               "page-locked memory only; torch does not see "
                               "the store as pinned")
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(self.free[i])
            self.bufs[i].copy_(src, non_blocking=True)
            self.done[i].record(self.stream)

    def acquire(self, i: int) -> None:
        if self.cuda:
            torch.cuda.current_stream().wait_event(self.done[i])

    def release(self, i: int) -> None:
        if self.cuda:
            self.free[i].record(torch.cuda.current_stream())


class InterleavedEngine:
    """LIME decode engine on one device (n_stage = 1): resident layers in
    HBM, streamed layers copied in from pinned host memory per pass."""

    def __init__(self, cfg: ModelConfig, plan: ExecutionPlan, *, mb: int = 1,
                 max_len: int = 256, retier_headroom: int = 0,
                 long_mode: bool = False, paged: bool = False,
                 page_size: int = 64, impl: str = "kernel", enc_len: int = 0,
                 device=None):
        if plan.n_stage != 1:
            raise NotImplementedError(
                "the port runs one stage; the multi-stage ring waits until a "
                "run shows more than one card")
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"the port's engine runs the dense, MoE, SSM, hybrid and "
                f"encoder-decoder families, not {cfg.family}")
        if M.n_dense_first(cfg):
            raise ValueError(HOMOGENEOUS)
        if cfg.family == Family.ENCDEC and enc_len <= 0:
            raise ValueError("the encoder-decoder engine needs enc_len > 0, "
                             "the encoder's frames (the encoder runs "
                             "outside the tiers)")
        self.cfg, self.plan = cfg, plan
        self.mb = mb
        self.max_len = max_len
        self.long_mode = long_mode
        self.impl = impl
        self.enc_len = int(enc_len) if cfg.family == Family.ENCDEC else 0
        self.device = resolve_device(device)
        self.k_res_b = plan.k_res_list
        self.k_off_b = plan.k_off_list
        self.k_res_cap = max(self.k_res_b)
        self.H = max(int(retier_headroom), 0)
        self.k_off_cap = self.H + max(self.k_off_b)
        self.k_res_live = list(self.k_res_b)
        self.S_c = M.kv_cache_len(cfg, max_len, long_mode)
        self.windows = M.layer_windows(cfg, cfg.n_layers, long_mode)
        # paged KV accounting (the JAX engine's): the per-slot cache is
        # carved into page_size-token pages of a PagePool; each slot holds
        # a block table, so the serving layer sees page-granular occupancy
        # and seed_cache moves K/V through real pages
        self.paged = paged and self.S_c > 0 and cfg.n_kv_heads > 0
        self.page_size = page_size
        if self.paged:
            self.pages_per_slot = -(-self.S_c // page_size)
            page_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                          * page_size * 2.0)            # k+v, bf16
            self.page_pool = PagePool(PagedKVConfig(
                page_size=page_size, device_pages=mb * self.pages_per_slot,
                page_bytes=page_bytes))
            self.slot_tables = [BlockTable(page_size) for _ in range(mb)]
            self._paged_pos = 0        # host mirror of the state's pos
        self._slots, self.layer_numel = _layer_slots(cfg)
        self._loaded_from = None
        self._res: Dict[int, torch.Tensor] = {}
        self._res_views: Dict[int, dict] = {}
        self._store: Optional[PinnedStore] = None
        self._streamer: Optional[_Streamer] = None
        self._buf_views: List[dict] = []
        self._shared: dict = {}
        # what fixes a captured draft step's graph beside its state (the
        # JAX engine's jitted draft program): every retier and weight load
        # bumps it
        self.layout_version = 0
        self._refresh_tier_inputs()
        self._build_res = self._res_ids      # the layout before any retier

    @property
    def layer_bytes(self) -> int:
        """Bytes of one packed layer (packed_layer_bytes)."""
        return self.layer_numel * 2

    # -- tiers -----------------------------------------------------------------
    def _refresh_tier_inputs(self) -> None:
        self._res_ids, self._off_ids = plan_layout(self.plan, self.H,
                                                   self.k_res_live)
        self.layout_version += 1

    def _real(self, l) -> bool:
        return int(l) < self.cfg.n_layers

    def _order(self, resident_only: bool) -> List[Tuple[int, Optional[Tuple[int, int]]]]:
        """Execution order of one pass: (layer id, None) for a resident
        layer, (layer id, (segment, store slot)) for a streamed one."""
        order = []
        for s in range(self.plan.n_seg):
            order += [(int(l), None) for l in self._res_ids[s, 0]
                      if self._real(l)]
            if not resident_only:
                order += [(int(l), (s, h))
                          for h, l in enumerate(self._off_ids[s, 0])
                          if self._real(l)]
        return order

    @staticmethod
    def _leaf_view(flat: torch.Tensor, shape: tuple, dtype: torch.dtype,
                   off: int) -> torch.Tensor:
        units = math.prod(shape) * dtype.itemsize // 2
        return flat[off:off + units].view(dtype).view(shape)

    def _views(self, flat: torch.Tensor) -> dict:
        tree: dict = {}
        for path, shape, dtype, off in self._slots:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self._leaf_view(flat, shape, dtype, off)
        return tree

    def _pack(self, p: dict, flat: torch.Tensor) -> None:
        for path, shape, dtype, off in self._slots:
            leaf = p
            for k in path:
                leaf = leaf[k]
            if tuple(leaf.shape) != shape or leaf.dtype != dtype:
                raise ValueError(f"layer leaf {'/'.join(path)}: "
                                 f"{tuple(leaf.shape)} {leaf.dtype}, want "
                                 f"{shape} {dtype}")
            self._leaf_view(flat, shape, dtype, off).copy_(leaf)

    @property
    def store(self) -> Optional[PinnedStore]:
        """The streamed tier's pinned host store (None before loading)."""
        return self._store

    @property
    def streamed_store_bytes(self) -> int:
        return self.plan.n_seg * self.k_off_cap * self.layer_numel * 2

    def _load(self, params: dict) -> None:
        """Resident layers into HBM, streamed ones into the pinned store,
        one layer at a time from params' layer source (or its stacked
        tree): the whole model never sits on the card."""
        self.close()
        dev = self.device
        self._shared = _to(dev, {k: v for k, v in params.items()
                                 if k != "layers"})
        self._store = PinnedStore((self.plan.n_seg, self.k_off_cap,
                                   self.layer_numel), dev)
        self._streamer = _Streamer(self.layer_numel, dev, self._store.pinned)
        self._buf_views = [self._views(b) for b in self._streamer.bufs]
        staging = self._streamer.bufs[0]
        for l in range(self.cfg.n_layers):
            p = M.layer_params(params, l)
            if (self._res_ids[:, 0] == l).any():
                flat = torch.zeros(self.layer_numel, dtype=torch.bfloat16,
                                   device=dev)
                self._pack(p, flat)
                self._res[l] = flat
                self._res_views[l] = self._views(flat)
            else:
                s, h = np.argwhere(self._off_ids[:, 0] == l)[0]
                self._pack(p, staging)
                self._store.data[s, h].copy_(staging)
            del p
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._loaded_from = params
        self.layout_version += 1

    def close(self) -> None:
        """Free the tiers (the pinned store is unregistered first)."""
        if self._store is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._store.close()
        self.layout_version += 1
        self._store = self._streamer = None
        self._res, self._res_views, self._shared = {}, {}, {}
        self._buf_views = []
        self._loaded_from = None

    # -- state -----------------------------------------------------------------
    def init_state(self, params: dict, reuse: Optional[dict] = None) -> dict:
        """Load the weights from params (shared leaves plus "layers", a
        stacked tree or a layer source, see M.init_params_by_layer) unless
        this params object is already loaded, and return a fresh state:
        an empty cache (K/V, recurrent states, zero cross K/V of enc_len
        frames) for mb sequences at pos 0. `reuse`, an earlier state of
        this engine, is cleared in place and returned instead: its tensors
        keep their addresses, so a draft step captured over it stays
        valid."""
        if "dense_layers" in params:
            raise ValueError(HOMOGENEOUS)
        if self._loaded_from is not params:
            self._load(params)
        if reuse is not None:
            return M.clear_cache(reuse)
        return self._empty_cache()

    def _empty_cache(self) -> dict:
        return M.init_cache(self.cfg, self.mb, self.max_len, self.long_mode,
                            device=self.device, enc_len=self.enc_len)

    # -- passes ----------------------------------------------------------------
    def _run_layers(self, x: torch.Tensor, body, resident_only: bool = False):
        """x through every layer of a pass in the tiers' order:
        body(weights, layer id, x) -> x on each resident layer's HBM
        views, and on each streamed layer's load buffer once its copy has
        landed, the next streamed layer's copy issued first (the
        interleave)."""
        order = self._order(resident_only)
        streamed = [where for _, where in order if where is not None]
        st, store = self._streamer, self._store.data
        if streamed:
            st.begin()
            st.fetch(0, store[streamed[0]])
        i = 0
        for l, where in order:
            if where is None:
                x = body(self._res_views[l], l, x)
                continue
            if i + 1 < len(streamed):       # interleave: next copy first
                st.fetch((i + 1) % 2, store[streamed[i + 1]])
            b = i % 2
            st.acquire(b)
            x = body(self._buf_views[b], l, x)
            st.release(b)
            i += 1
        if streamed:
            st.end()
        return x

    def _check_loaded(self) -> None:
        if self._loaded_from is None:
            raise RuntimeError("init_state(params) loads the weights first")

    def _scope(self, cache: dict):
        """What a captured pass over `cache` reads and writes beyond its
        static buffers: the tier layout (resident layers' HBM, which
        retier and weight loads change; both bump layout_version), the
        pinned store's address and the cache's tensors."""
        return lambda: (self.layout_version, self._store.data.data_ptr(),
                        capture.tensor_scope(cache))

    def _pass(self, state: dict, tokens: torch.Tensor, *, multi: bool,
              resident_only: bool = False,
              steps: Optional[CapturedStep] = None):
        """One pass: the host prelude (M.step_prelude's checks), the device
        body (_pass_body), then pos advanced. With `steps` the body
        replays its CUDA graph for the shape, streamed layers included
        (their copies and events are graph nodes, see _Streamer)."""
        self._check_loaded()
        q_len = tokens.shape[1]
        M.step_prelude(self.cfg, state, q_len, impl=self.impl, multi=multi,
                       enc_len=self.enc_len)

        def body(tok, pos):
            return self._pass_body(state, tok, pos, multi=multi,
                                   resident_only=resident_only)
        logits = capture.run(
            steps, ("pass", multi, resident_only), body, tokens, state["pos"],
            scope=self._scope(state), device=self.device)
        state["pos"] += q_len
        return logits

    def _pass_body(self, state: dict, tokens: torch.Tensor, pos: torch.Tensor,
                   *, multi: bool, resident_only: bool) -> torch.Tensor:
        """The device body of a pass: tokens (mb, q_len) at positions
        pos + i (pos a 0-d int32 device tensor equal to state["pos"])
        through the tiers, M.step_layer on each layer. Returns logits."""
        cfg = self.cfg
        x = M.embed(self._shared, tokens).to(torch.bfloat16)
        slots = M.new_positions(state, tokens.shape[1], pos) \
            if "pos_ids" in state else None

        def body(p, l, x):
            return M.step_layer(cfg, p, x, state, l, slots, pos,
                                self.windows[l], impl=self.impl, multi=multi,
                                enc_len=self.enc_len)
        x = self._run_layers(x, body, resident_only)
        x = rms_norm(x, self._shared["final_norm"], cfg.norm_eps)
        return unembed(self._shared, x)

    def encode(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder-decoder family's encoder (M.encode) on the engine's
        shared, resident encoder weights. frame_embeds: (mb, enc_len, D)."""
        self._check_loaded()
        return M.encode(self.cfg, self._shared, frame_embeds, impl=self.impl)

    def prefill(self, tokens: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None, *,
                cache: Optional[dict] = None,
                steps: Optional[CapturedStep] = None):
        """The prompt pass of every family over the engine's own tiers (the
        counterpart of the JAX backend's M.prefill on replicated params,
        which one card cannot hold): M.prefill_layer on each layer's
        weights, resident ones from HBM, streamed ones through the load
        buffers in the interleave of a pass, into a fresh model-layout
        cache for mb sequences (long_mode's windows and ring). tokens:
        (mb, S). The encoder-decoder family needs enc_out (mb, enc_len, D),
        the encoder's output: each layer's cross K/V are projected from it
        by that layer's own weights (M.cross_kv_layer) just before the
        layer runs. Returns (last-token logits (mb, 1, PV), cache):
        M.prefill's (after M.seed_cross_kv) on the same weights, bit for
        bit, for seed_cache to adopt. `cache`, a model-layout cache of this
        engine's shapes allocated by the caller (the serving backend passes
        its state), is cleared and written in place instead of a new one:
        a captured prompt pass (`steps`, one CUDA graph per prompt shape)
        must write memory outside its graph pool, at addresses its scope
        names."""
        self._check_loaded()
        cfg = self.cfg
        if cfg.family == Family.ENCDEC:
            if enc_out is None or tuple(enc_out.shape[:2]) != (
                    self.mb, self.enc_len):
                raise ValueError(
                    f"the encoder-decoder prompt pass needs enc_out "
                    f"({self.mb}, {self.enc_len}, {cfg.d_model}), the "
                    f"encoder's output")
        elif enc_out is not None:
            raise ValueError(f"enc_out feeds the encoder-decoder family, "
                             f"not {cfg.family}")
        if cache is None:
            cache = self._empty_cache()
        else:
            self._check_cache(cache)
        cache["pos"] = 0                    # clear_cache's host half
        inputs = (enc_out,) if enc_out is not None else ()

        def body(tok, pos, *inp):
            return self._prompt_body(cache, tok, *inp)
        logits = capture.run(steps, ("prompt", bool(inputs)), body, tokens,
                             0, scope=self._scope(cache), device=self.device,
                             inputs=inputs)
        M.prefill_epilogue(cache, tokens.shape[1])
        return logits, cache

    def _prompt_body(self, cache: dict, tokens: torch.Tensor,
                     enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The device body of the prompt pass: the cache cleared in place,
        every layer over the tiers (cross K/V first where enc_out is
        given), pos_ids written. Returns the last-token logits."""
        cfg = self.cfg
        M.clear_tensors(cache)
        x = M.embed(self._shared, tokens).to(torch.bfloat16)

        def body(p, l, x):
            if enc_out is not None:
                cache["xk"][l], cache["xv"][l] = M.cross_kv_layer(p, enc_out)
            return M.prefill_layer(cfg, p, x, cache, l, self.windows[l],
                                   impl=self.impl)
        x = self._run_layers(x, body)
        M.prompt_pos_ids(cache, x.shape[1])
        x = rms_norm(x[:, -1:], self._shared["final_norm"], cfg.norm_eps)
        return unembed(self._shared, x)

    def _check_cache(self, cache: dict) -> None:
        """A caller's cache must have this engine's entries and shapes."""
        want = M.init_cache(self.cfg, self.mb, self.max_len, self.long_mode,
                            device="meta", enc_len=self.enc_len)
        for key, t in want.items():
            got = cache.get(key)
            if isinstance(t, torch.Tensor) and not (
                    isinstance(got, torch.Tensor) and got.shape == t.shape
                    and got.dtype == t.dtype
                    and got.device.type == self.device.type):
                raise ValueError(f"cache entry {key}: the engine's prompt "
                                 f"pass needs {tuple(t.shape)} {t.dtype} on "
                                 f"{self.device}")

    def seed_cache(self, state: dict, cache: dict) -> dict:
        """Adopt a model-layout cache (prefill's, or M.prefill's for mb
        sequences) as the engine's state: its entries replace the state's,
        in place; returns the state. Paged: each slot's block table is
        rebuilt to hold the cache's pos tokens and its K/V rows move
        through the table's pool pages and back (scatter_to_pages /
        gather_from_pages), an identity by construction that exercises
        the table indirection on whatever pages the free list handed out."""
        for key, v in cache.items():
            old = state.get(key)
            if isinstance(old, torch.Tensor) and (
                    tuple(v.shape) != tuple(old.shape) or v.dtype != old.dtype):
                raise ValueError(f"cache entry {key}: {tuple(v.shape)} "
                                 f"{v.dtype}, the engine holds "
                                 f"{tuple(old.shape)} {old.dtype}")
        ctx = int(cache["pos"]) if self.paged else 0
        if self.paged:
            self._paged_pos = ctx
            self._paged_seed_slots(ctx)
        for key, v in cache.items():
            if self.paged and key in ("k", "v"):
                v = self._through_pages(v, ctx)
            if v is state.get(key):     # the prompt pass wrote the state
                continue
            if isinstance(state.get(key), torch.Tensor):
                state[key].copy_(v)     # in place: a captured pass over
            else:                       # the state stays valid
                state[key] = v
        return state

    def decode_step(self, state: dict, tokens: torch.Tensor, *,
                    steps: Optional[CapturedStep] = None):
        """tokens: (mb, 1) -> (logits (mb, PV), state), pos advanced by 1.
        With `steps` the pass replays its CUDA graph."""
        return self._pass(state, tokens, multi=False,
                          steps=steps)[:, 0], state

    @staticmethod
    def _masked(tokens, active):
        active = torch.as_tensor(active, dtype=torch.bool,
                                 device=tokens.device)
        return torch.where(active[:, None], tokens, torch.zeros_like(tokens))

    def decode_requests(self, state, tokens, active, *, steps=None):
        """decode_step where only the `active` slots are live: inactive
        slots ride as padding with zeroed tokens; their logits are to be
        ignored. Paged: each live slot's table grows to the new position
        (a page every page_size steps)."""
        if self.paged:
            self._paged_pos += 1
            for slot in np.flatnonzero(np.asarray(
                    torch.as_tensor(active).cpu(), bool)):
                self.extend_slot(int(slot), self._paged_pos)
        return self.decode_step(state, self._masked(tokens, active),
                                steps=steps)

    def verify_step(self, state: dict, tokens: torch.Tensor, *,
                    steps: Optional[CapturedStep] = None):
        """Score q_len positions per slot in one pass (one weight stream).
        tokens: (mb, q_len), column 0 the last committed token, the rest
        drafted. Returns (logits (mb, q_len, PV), state) with pos advanced
        by q_len and all q_len K/V written; rollback() commits a prefix.
        Dense and MoE families only (a recurrent state cannot roll
        back). With `steps` the pass replays its CUDA graph for q_len."""
        if self.cfg.family not in M.PURE_KV:
            raise NotImplementedError(
                f"speculative verification needs pure-KV per-layer state "
                f"(DENSE/MOE), not {self.cfg.family}")
        q_len = tokens.shape[1]
        if not 1 <= q_len < max(self.S_c, 2):
            raise ValueError(f"q_len {q_len} must be in [1, {self.S_c})")
        return self._pass(state, tokens, multi=True, steps=steps), state

    def verify_requests(self, state, tokens, active, *, steps=None):
        return self.verify_step(state, self._masked(tokens, active),
                                steps=steps)

    def draft_step(self, state: dict, tokens: torch.Tensor, *,
                   steps: Optional[CapturedStep] = None):
        """One decode step through only the live resident tier (nothing
        streamed), the final norm and lm_head as the early-exit draft
        head. tokens: (mb, 1) -> (logits (mb, PV), state), pos advanced by
        1. Its K/V land in resident layers only; after rollback the verify
        pass overwrites every layer's rows at the drafted positions before
        reading them, so drafting leaks nothing into the verified stream.
        It never touches the page accounting (note_committed does). With
        `steps` (the caller's CapturedStep) it replays a CUDA graph, one
        per batch shape and layout version."""
        if self.cfg.family not in M.PURE_KV:
            raise NotImplementedError(
                f"resident self-draft needs pure-KV per-layer state "
                f"(DENSE/MOE), not {self.cfg.family}")
        if self.k_res_cap == 0:
            raise ValueError("resident self-draft needs a resident tier "
                             "(this plan streams every layer)")
        return self._pass(state, tokens, multi=False, resident_only=True,
                          steps=steps)[:, 0], state

    def draft_requests(self, state, tokens, active, *, steps=None):
        return self.draft_step(state, self._masked(tokens, active),
                               steps=steps)

    def prefill_partial(self, state: dict, tokens: torch.Tensor, *,
                        chunk: int = 0, steps: Optional[CapturedStep] = None):
        """Prefill (mb, T) prompt positions from the state's pos through
        the engine itself: ceil(T / chunk) verify rounds, each one pass
        (one weight stream) over `chunk` positions. Returns (the last
        round's logits (mb, q, PV), state) with pos advanced by T. Dense
        and MoE families only; paged: the slot tables are rebuilt at the
        prefilled span (released, then extended). With `steps` each round
        replays the verify pass's CUDA graph for its width."""
        if self.cfg.family not in M.PURE_KV:
            raise NotImplementedError(
                "partial-context prefill rides the multi-query verify "
                "step (pure-KV families only)")
        T = int(tokens.shape[1])
        chunk = T if chunk <= 0 else min(chunk, T)
        logits = None
        for off in range(0, T, chunk):
            logits, state = self.verify_step(
                state, tokens[:, off:off + chunk], steps=steps)
        if self.paged:
            self._paged_pos = state["pos"]
            self._paged_seed_slots(state["pos"])
        return logits, state

    def rollback(self, state: dict, pos: int) -> dict:
        """Reset the decode position to `pos` (commit an accepted prefix of
        a verify round): rejected positions' entries hold pos_ids > pos,
        invisible to attention until decoding overwrites them."""
        state["pos"] = int(pos)
        return state

    # -- paged slot accounting ---------------------------------------------------
    def _paged_seed_slots(self, ctx: int) -> None:
        """(Re)build every slot's block table to hold `ctx` tokens."""
        for t in self.slot_tables:
            self.page_pool.release_table(t)
        for t in self.slot_tables:
            self.page_pool.extend_table(t, min(ctx, self.S_c))

    def _through_pages(self, x: torch.Tensor, ctx: int) -> torch.Tensor:
        """A model-layout (L, B, S_c, ...) K or V stack round-tripped
        through the page pool: each slot's first ctx rows scattered into
        its table's pages, then gathered back into a copy."""
        ctx = min(ctx, self.S_c)
        pool = x.new_zeros((x.shape[0], self.page_pool.alloc.n_pages,
                            self.page_size) + tuple(x.shape[3:]))
        scatter_to_pages(pool, x, self.slot_tables, ctx)
        return gather_from_pages(x.clone(), pool, self.slot_tables, ctx)

    def extend_slot(self, slot: int, n_tokens: Optional[int] = None) -> None:
        """Page-granular growth of one slot (per decode step for live
        slots), capped at S_c tokens: the pool holds pages_per_slot pages
        a slot, so it never runs dry."""
        t = self.slot_tables[slot]
        target = t.tokens + 1 if n_tokens is None else n_tokens
        self.page_pool.extend_table(t, min(target, self.S_c))

    def free_slot(self, slot: int) -> None:
        """Release a completed request's pages (the serving release hook)."""
        self.page_pool.release_table(self.slot_tables[slot])

    def paged_stats(self) -> Dict[str, object]:
        return {"pages_in_use": self.page_pool.pages_in_use(),
                "page_size": self.page_size,
                "slot_tokens": [t.tokens for t in self.slot_tables]}

    def note_committed(self, pos: int, active) -> None:
        """Paged bookkeeping after a spec round: live slots grow to the
        committed context (several tokens a round); rejected candidates
        never had pages."""
        if not self.paged:
            return
        self._paged_pos = pos
        for slot in np.flatnonzero(np.asarray(torch.as_tensor(active).cpu(),
                                              bool)):
            self.extend_slot(int(slot), pos)

    # -- online memory adaptation ----------------------------------------------
    def demoted(self, stage: int) -> int:
        return self.k_res_b[stage] - self.k_res_live[stage]

    def demote_capacity(self, stage: int) -> int:
        return min(self.k_res_b[stage], self.H) - self.demoted(stage)

    def slot_hbm_bytes(self, stage: int = 0, j: int = 0) -> float:
        """HBM resident slot j of `stage` returns when demoted (Eq. 7's
        (#Seg - 1) factor: the slot holds one layer per segment, and the
        streamed tier keeps a one-layer load buffer). A slot that some
        segments leave empty (a resident count that does not divide the
        segments) holds fewer layers."""
        n = int((self._build_res[:, stage, j] < self.cfg.n_layers).sum())
        return max(n - 1, 1) * self.cfg.layer_params() * 2.0

    def resident_layer_ids(self) -> List[int]:
        ids = np.unique(self._res_ids[self._res_ids < self.cfg.n_layers])
        return [int(i) for i in ids]

    def resident_fraction(self) -> float:
        return len(self.resident_layer_ids()) / max(self.cfg.n_layers, 1)

    def retier_stats(self) -> Dict[str, list]:
        return {"k_res_build": list(self.k_res_b),
                "k_res_live": list(self.k_res_live),
                "demoted": [self.demoted(d) for d in range(self.plan.n_stage)]}

    def retier(self, state, stage: int, delta: int):
        """Move `delta` resident slots of `stage` across the tier boundary
        (positive: demote resident -> streamed, negative: promote back),
        between steps of a live serve. A demoted slot's layer (one per
        segment) is copied into its headroom slot of the pinned store and
        its HBM released; a promotion copies it back. The KV cache does not
        move (it is indexed by layer id), so the next pass reads the same
        rows. Returns (state, freed_bytes), freed_bytes < 0 on promotion.
        Before init_state loads weights only the counters move."""
        if delta == 0:
            return state, 0.0
        if stage != 0:
            raise ValueError("the port's engine has one stage (0)")
        assert self.H > 0 or delta < 0, \
            "retier needs retier_headroom > 0 at engine build"
        loaded = self._loaded_from is not None
        if loaded and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        kr_b = self.k_res_b[stage]
        freed, moves = 0.0, 0
        for _ in range(abs(delta)):
            if delta > 0:
                if self.k_res_live[stage] <= 0 or self.demote_capacity(stage) <= 0:
                    break
                j = self.k_res_live[stage] - 1
                h = self.H - (kr_b - j)
                for s in range(self.plan.n_seg):
                    l = int(self._res_ids[s, stage, j])
                    if loaded and self._real(l):
                        self._store.data[s, h].copy_(self._res.pop(l))
                        del self._res_views[l]
                self.k_res_live[stage] = j
                freed += self.slot_hbm_bytes(stage, j)
            else:
                if self.k_res_live[stage] >= kr_b:
                    break
                j = self.k_res_live[stage]
                h = self.H - (kr_b - j)
                for s in range(self.plan.n_seg):
                    l = int(self._off_ids[s, stage, h])
                    if loaded and self._real(l):
                        flat = self._store.data[s, h].to(self.device)
                        self._res[l] = flat
                        self._res_views[l] = self._views(flat)
                self.k_res_live[stage] = j + 1
                freed -= self.slot_hbm_bytes(stage, j)
            moves += 1
            self._refresh_tier_inputs()
        if loaded and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return state, (freed if moves else 0.0)
