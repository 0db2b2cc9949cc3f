"""Inference engine: prefill / decode steps + generation loop.

Port of ``llm_inference_engine_tpu/runtime/engine.py``, over the slot
cache, the paged pool or context-parallel append logs. The JAX package's
jitted closures become methods. Kept from it: power-of-two prefill
buckets, chunked prefill with the near-capacity bucket shrink and the
loud capacity refusal, per-slot penalty count planes, logprobs,
multi-round history in the cache, and the one-token top-up of
length-terminated rows.

Decode runs as the JAX engine's device programs do, one device program a
step or a rollout with its state on the device (``runtime/decode_graph.py``):

- ``decode_step`` (JAX ``_decode_step``): one step over all slots;
- ``decode_rollout`` (JAX ``_decode_rollout``'s ``lax.scan``): the greedy
  step replayed ``num_steps`` times into a preallocated buffer;
- ``generate``'s non-streaming tail (JAX ``_sampled_rollout``'s
  ``while_loop``): penalties, the draw, stop ids and the capacity check
  (``lengths < max_seq_len - 1``) on the device, inactive rows emitting
  -1, the host stopping once a flag says no row is active.

On a CUDA device each of the three bodies is captured into a CUDA graph at
its first use (batch ``max_batch_size``, a memory pool each) and replayed
from then on; a capture that fails raises, naming the op. The CPU runs the
same bodies eagerly. The bodies read their inputs from one static buffer
that the host fills in one copy before a replay, and keep all state in
place: the cache and its lengths, the count planes, the block table.
Lengths also have a host mirror, which the engine keeps in step; a
rollout refreshes it from the device in the same copy as its tokens.
Kernel D's decode plan does not depend on the context length, so one
graph serves every length. What stays eager, and why: prefill and the
scheduler's mixed prefill+decode steps (their shapes follow the chunk
bucket), the first token's sample, and ``generate`` with a stream
callback, which runs ``decode_step`` replays and reads each step's tokens
on the host.

Paged layout (``kv_layout="paged"``, ``ops/paged_kv.py``): the page
management of the JAX engine — chunk size capped to the page, a
host-side refcounting allocator, page-aligned multi-token writes,
capacity grown on the host before every write and before every replay
(``ensure_capacity``; MemoryError on exhaustion, where the scheduler
preempts), the worst case of a rollout reserved before its first step,
pages released by ``reset`` and shared by the prefix caches. The block
table has a host mirror; the device table is updated in place from pinned
memory, and only when the host table changed, so a graph reads the new
entries.

Weights may be dense or quantized (``ops/quant.py``); the engine does
not look at them. The KV cache takes the model's dtype, as the JAX
engine's does (``kv_cache_dtype_of``): ``kv_cache_dtype_name="int8"``
gives an int8 cache or pool with f32 scale planes (``ops/kv_cache.py``,
``ops/paged_kv.py``), and any float name gives a cache of the model's
dtype. The slot cache picks its scale numerics by device as the JAX
engine does, the pool is always snapped.

Dtypes on the card (``check_kernel_dtypes``): a bfloat16 model runs
kernels A-I; a float16 or float32 model (the ``debug`` preset is
float32) runs A, B, C and H, which take its rows as they are, and the
float instances of the others (D2f, Df, Ef and Ff:
``csrc/attention_*_f16.cu``, ``csrc/quant_matmul_f16.cu`` and their
``_f32.cu``; If: kernel I's ``csrc/kv_write_quant.cu`` over float16 and
float32 rows). A pool of the model's dtype or int8 decodes through the
fused paged decode (D or Df), which writes the token's row (an int8
pool's quantized) and attends in one launch a layer.

Meshes (``EngineConfig.dp``/``tp``, or a ``parallel.mesh.Mesh`` passed
in; ``parallel/sharding.py``): the weights are sharded over the model
ranks and the slots over the data ranks (data rank d owns slots
``[d * B / dp, (d + 1) * B / dp)``), the cache or pool is a
``MeshCache`` of per-rank shards, and every forward runs each rank's
layer body on its local shapes with the same kernels. Everything else of
the engine (inputs, sampling, penalty counts, the global lengths and
block table, the page allocator) stays as it is on the mesh's home
device, rank (0, 0)'s: the scheduler, the server and the prefix caches
of the paged layout see the same engine. A block-table upload reaches
every data group. On a mesh whose devices are all one card the decode
bodies stay CUDA-graph replays (the whole step is on one device); on a
mesh of several cards they run eagerly (ROADMAP.md, queue 2 item 7). Without a
mesh, ``dp``/``tp`` > 1 build one over ``cuda:0 ... cuda:n-1``, or over
n copies of the CPU when the engine's device is the CPU. A mesh comes
from one place, and ``engine_config`` then carries its ``dp``/``tp``:
``ShardedParams`` bring theirs (a different ``mesh=`` raises), a
``mesh=`` must agree with any ``dp``/``tp``/``cp`` > 1 (ValueError).

Context parallelism (``cp`` > 1, a mesh with a ``seq`` axis;
``parallel/cp_engine.py``): the cache is a ``CPCache`` of per-rank
append logs, and the host mirrors its ``llen`` [B, cp] as it mirrors the
lengths: prefill by the chunk split (refusing, as the JAX engine does, a
chunk a local log cannot hold, after shrinking the padded bucket to a
floor of 2 * cp rows and an exact-fit tail), decode by the argmin rule,
never read back. A prefill attends the rows its mirror says are written
(rounded up to the CP attention's 512-row blocks); the decode bodies
read whole local logs, so that one captured graph serves every length.
Refused with the JAX engine's messages: cp with the paged pool, a log
neither bf16 (the model dtype) nor int8. Not ported
(NotImplementedError): an int8 pool under a mesh (the JAX package's
limit), and on a cp engine the slot ``PrefixStore`` and speculation,
whose JAX counterparts give wrong ids or fail there (ROADMAP.md, queue
3). Over a dp x tp mesh the slot prefix stores, speculation and beam
search run (``runtime/prefix_cache.py``, ``runtime/speculative.py``,
``runtime/beam_search.py``); beams also over a cp engine's params.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingParams, resolve_rope_scaling)
from llm_inference_engine_tpu_torch.models import llama as llama_model
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
from llm_inference_engine_tpu_torch.ops import quant
from llm_inference_engine_tpu_torch.ops.sampling import (
    apply_penalties, greedy_sample, sample_tokens, token_logprobs)
from llm_inference_engine_tpu_torch.parallel import cp_engine, sharding
from llm_inference_engine_tpu_torch.parallel.cp_cache import (
    new_cp_cache, reset_cp_cache)
from llm_inference_engine_tpu_torch.parallel.mesh import Mesh, make_mesh
from llm_inference_engine_tpu_torch.parallel.context_parallel import BLOCK_KV
from llm_inference_engine_tpu_torch.runtime import decode_graph
from llm_inference_engine_tpu_torch.utils import debug, round_up

__all__ = ["InferenceEngine", "GenerationResult", "check_kernel_dtypes",
           "kv_cache_dtype_of"]

# Rows of the decode programs' input buffer, int32 [len(INPUT_ROWS), B];
# the float rows hold f32 bits. A rollout keeps its carry there too:
# ``tokens`` the last token of each row, ``active`` the rows still running.
INPUT_ROWS = ("tokens", "active", "temperature", "top_k", "top_p", "min_p",
              "repetition", "presence", "frequency")
_FLOAT_ROWS = frozenset((2, 4, 5, 6, 7, 8))
_NEUTRAL_EXTRAS = (0.0, 1.0, 0.0, 0.0)   # min_p, repetition, presence, freq.


@dataclasses.dataclass(frozen=True)
class _Inputs:
    """Typed views of the rows of the input buffer."""
    tokens: torch.Tensor
    active: torch.Tensor
    temperature: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    extras: tuple       # min_p, repetition, presence, frequency

    @classmethod
    def of(cls, buf: torch.Tensor) -> "_Inputs":
        rows = [buf[i].view(torch.float32) if i in _FLOAT_ROWS else buf[i]
                for i in range(len(INPUT_ROWS))]
        return cls(*rows[:5], tuple(rows[5:]))


@dataclasses.dataclass
class GenerationResult:
    token_ids: list[list[int]]          # per sequence, generated ids only
    num_prompt_tokens: list[int]
    num_generated: list[int]
    # per generated token: log P(token) under the model's (penalized)
    # distribution, aligned with token_ids
    logprobs: Optional[list[list[float]]] = None


def _bucket_len(n: int, floor: int = 16, cap: int | None = None) -> int:
    """Round up to a power of two (bounds the distinct prefill shapes)."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b


def kv_cache_dtype_of(config: ModelConfig, eng: EngineConfig):
    """(dtype, quantized) of the engine's KV cache, as the JAX engine
    allocates it: int8 with scale planes for ``kv_cache_dtype_name="int8"``,
    else the model's dtype, whatever float the name gives."""
    quantized = eng.kv_cache_dtype == torch.int8
    return (torch.int8 if quantized else config.dtype), quantized


def check_kernel_dtypes(config: ModelConfig, eng: EngineConfig,
                        device) -> None:
    """Refuse, before anything is allocated, an engine whose kernels
    cannot take its dtypes: on a CUDA device with ``kernels`` other than
    "torch", the kernels take a bfloat16 model (kernels A-I) or a float16
    or float32 one (A, B, C, H and the float instances D2f, Df, If, Ef,
    Ff); the cache is of the model's dtype or int8
    (:func:`kv_cache_dtype_of`)."""
    if torch.device(device).type != "cuda" or eng.kernels == "torch":
        return
    if config.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"{config.name}: model dtype {config.dtype} on "
                         f"{device}: the CUDA kernels take bfloat16, "
                         "float16 or float32; use kernels='torch'")


def _check_layout(eng: EngineConfig) -> None:
    if eng.kv_layout not in ("slot", "paged"):
        raise ValueError(f"kv_layout must be 'slot' or 'paged', got "
                         f"{eng.kv_layout!r}")


def _mesh_for(eng: EngineConfig, device: torch.device) -> Optional[Mesh]:
    """The mesh that ``dp``/``tp``/``cp`` ask for (None for one rank): the
    CPU n times over for a CPU engine, else ``cuda:0 ... cuda:n-1``."""
    n = eng.dp * eng.tp * eng.cp
    if n == 1:
        return None
    return make_mesh(eng.dp, eng.tp, eng.cp,
                     devices=[device] * n if device.type == "cpu" else None)


def _config_of(eng: EngineConfig, mesh: Mesh) -> EngineConfig:
    """``eng`` with the mesh's ``dp``/``tp``/``cp``: the engine's config
    always describes its mesh. Sizes left at 1 take the mesh's; others
    must equal them (ValueError)."""
    if (eng.dp, eng.tp, eng.cp) not in ((1, 1, 1),
                                        (mesh.dp, mesh.tp, mesh.cp)):
        cp = eng.cp > 1 or mesh.cp > 1
        raise ValueError(
            f"EngineConfig dp={eng.dp} tp={eng.tp}"
            + (f" cp={eng.cp}" if cp else "")
            + f" disagrees with the mesh's dp={mesh.dp} tp={mesh.tp}"
            + (f" cp={mesh.cp}" if cp else ""))
    return eng.replace(dp=mesh.dp, tp=mesh.tp, cp=mesh.cp)


def _refuse_for_cp(eng: EngineConfig, paged: bool) -> None:
    """What the JAX engine refuses under cp > 1, with its messages."""
    if paged:
        raise NotImplementedError(
            "cp>1 + paged KV: the page pool is a single-chip memory "
            "manager; CP's capacity axis replaces it "
            "(docs/ADR-composition-matrix.md)")
    if eng.kv_cache_dtype not in (None, torch.int8):
        raise NotImplementedError(
            f"cp>1 supports bf16 or int8 KV logs, not "
            f"{eng.kv_cache_dtype_name}")


def add_decode_layouts(config: ModelConfig, engine_config: EngineConfig,
                       params, device) -> None:
    """Kernel E's fragment mode (INT4 at m <= 16, a bf16 or float16 model)
    reads each weight's copy in fragment order: build it once, in place,
    on every INT4 weight the kernels will run on the card, after the
    tensor-parallel sharding (each rank's shard). Nothing on the CPU or
    with ``kernels="torch"``; weights that have it already keep it."""
    if torch.device(device).type != "cuda" or engine_config.kernels == "torch":
        return
    quant.add_decode_layouts(
        params.grid if isinstance(params, sharding.ShardedParams)
        else params, config.dtype)


class InferenceEngine:
    """Engine over one model replica, on one device or over a mesh, and
    its slot cache or paged pool."""

    def __init__(self, config: ModelConfig, engine_config: EngineConfig,
                 params: dict, rng_seed: int = 0, device=None,
                 mesh: Optional[Mesh] = None):
        _check_layout(engine_config)
        if isinstance(params, sharding.ShardedParams):
            if mesh is not None and not mesh.same_as(params.mesh):
                raise ValueError("params are sharded over another mesh than "
                                 "the mesh= given: shard them over it, or "
                                 "leave mesh= out")
            mesh = params.mesh
        if mesh is None:
            device = torch.device(device if device is not None
                                  else params["embed"].device)
            mesh = _mesh_for(engine_config, device)
        self.mesh = mesh
        if mesh is not None:
            engine_config = _config_of(engine_config, mesh)
            device = mesh.home
        check_kernel_dtypes(config, engine_config, device)
        # NTK rope scaling folds into rope_theta at the engine's context
        # length (config.NTKScaling: one theta, cached keys consistent)
        config = resolve_rope_scaling(config, engine_config.max_seq_len)
        self.config = config
        self.engine_config = engine_config
        self.device = device
        self.cp = 1 if mesh is None else mesh.cp
        self.paged = engine_config.kv_layout == "paged"
        if self.cp > 1:
            _refuse_for_cp(engine_config, self.paged)
        self._fwd = None
        if self.cp > 1:
            self._fwd = cp_engine.make_cp_forward(config, engine_config, mesh)
        elif mesh is not None:
            self._fwd = sharding.make_sharded_forward(config, engine_config,
                                                      mesh)
        if mesh is not None and not isinstance(params,
                                               sharding.ShardedParams):
            params = sharding.shard_params(params, mesh)
        self.params = params
        add_decode_layouts(config, engine_config, params, device)
        B, V = engine_config.max_batch_size, config.vocab_size
        # an int8 cache holds int8 values and f32 scale planes
        dtype, quantized = kv_cache_dtype_of(config, engine_config)
        if self.cp > 1:
            self.cache = new_cp_cache(
                config.num_layers, B, config.num_kv_heads,
                engine_config.max_seq_len, config.head_dim, mesh,
                dtype=dtype, quantized=quantized)
            self._llen = np.zeros((B, self.cp), np.int32)   # host mirror
        elif self.paged:
            self._init_paged(dtype, quantized)
        else:
            self.cache = self._new_cache(
                lambda b, k, dev: kvc.new_kv_cache(
                    config.num_layers, b, k, engine_config.max_seq_len,
                    config.head_dim, dtype=dtype, device=dev,
                    quantized=quantized))
        self._lengths = np.zeros((B,), np.int32)     # host mirror
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        # context / generated token-occurrence counts per slot (drive the
        # repetition / presence / frequency penalties; ops/sampling.py)
        self._counts_ctx = torch.zeros((B, V), dtype=torch.int32,
                                       device=self.device)
        self._counts_gen = torch.zeros_like(self._counts_ctx)
        self._init_decode_programs()

    def _new_cache(self, new, max_pages: Optional[int] = None):
        """``new(batch, kv_heads, device)``'s cache at the engine's batch
        and head count, or a ``MeshCache`` of one at each rank's."""
        B, K = self.engine_config.max_batch_size, self.config.num_kv_heads
        if self.mesh is None:
            return new(B, K, self.device)
        return sharding.sharded_cache(self.mesh, new, B, K, max_pages)

    def _init_paged(self, dtype: torch.dtype, quantized: bool) -> None:
        if self.mesh is not None and quantized:
            raise NotImplementedError(sharding.INT8_POOL_REFUSAL)
        eng = self.engine_config
        page = eng.page_size
        # multi-token writes must stay within one page: the chunk size
        # divides the page (ops/paged_kv.py write invariant)
        C = max(1, eng.max_prefill_len)
        if C > page:
            eng = self.engine_config = eng.replace(max_prefill_len=page)
        elif page % C:
            raise ValueError(f"page_size {page} must be a multiple of "
                             f"max_prefill_len {C}")
        B = eng.max_batch_size
        maxp = -(-eng.max_seq_len // page)
        num_pages = eng.num_pages or (B * maxp + 1)   # +1: reserved page 0
        self.cache = self._new_cache(
            lambda b, k, dev: pkv.new_paged_kv_cache(
                self.config.num_layers, b, k, num_pages, page,
                self.config.head_dim, maxp, dtype=dtype, device=dev,
                quantized=quantized), maxp)
        self._allocator = pkv.PageAllocator(num_pages)
        self._slot_pages: list[list[int]] = [[] for _ in range(B)]
        self._table_host = np.zeros((B, maxp), np.int32)
        if self.device.type == "cuda":
            # staging for in-place uploads; the event marks the last
            # upload's copy done, so the buffer may be overwritten
            self._table_pinned = torch.zeros((B, maxp), dtype=torch.int32,
                                             pin_memory=True)
            self._table_copied = torch.cuda.Event()

    def _init_decode_programs(self) -> None:
        """The static buffers of the decode programs, and (on the card)
        the table of their captured graphs, filled at first use."""
        B, S = self.engine_config.max_batch_size, self.engine_config.max_seq_len
        dev = self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self._input_buf = zeros(len(INPUT_ROWS), B)
        self._x = _Inputs.of(self._input_buf)
        self._step_out = zeros(2, B)          # next token, its logprob bits
        # the rollouts' step index and outputs, a row a step
        self._roll_i = zeros(1, dtype=torch.int64)
        self._roll_tok = zeros(S, B)
        self._roll_lp = zeros(S, B, dtype=torch.float32)
        self._roll_flag = zeros(1, dtype=torch.bool)   # any row active
        self._stop_mask = zeros(self.config.vocab_size, dtype=torch.bool)
        self._flags = decode_graph.FlagPoll(self._roll_flag)
        cuda = dev.type == "cuda"
        # graphs by body name on the card; None runs the bodies eagerly
        # (also over a mesh of several cards: a graph is one device's)
        one_device = self.mesh is None or self.mesh.one_device
        self._programs: Optional[dict] = {} if cuda and one_device else None
        if cuda:
            self._input_pinned = torch.zeros(self._input_buf.shape,
                                             dtype=torch.int32,
                                             pin_memory=True)
            self._input_copied = torch.cuda.Event()
            self._input_host = self._input_pinned.numpy()
        else:
            self._input_host = self._input_buf.numpy()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        """Host values -> a tensor on the engine's device. Host data goes
        through pinned memory: a copy from pageable memory would wait for
        the card to drain its queue, so the host could never run ahead."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=dtype)
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _set_lengths(self, lengths) -> None:
        self._lengths = np.asarray(lengths, np.int32).copy()
        self.cache.lengths.copy_(self._dev(self._lengths))

    def _upload_table(self) -> None:
        """Copy the host block table into the device table, in place. On
        the card the copy leaves from pinned memory and does not make the
        host wait for the card; the staging buffer is rewritten only after
        the previous upload's copy has run."""
        table = self.cache.block_table
        if self.device.type != "cuda":
            table.copy_(torch.from_numpy(self._table_host))
        else:
            self._table_copied.synchronize()
            self._table_pinned.numpy()[...] = self._table_host
            table.copy_(self._table_pinned, non_blocking=True)
        if self.mesh is not None:
            self.cache.upload_table()
        if self.device.type == "cuda":
            self._table_copied.record()

    @staticmethod
    def _count_tokens(counts: torch.Tensor, token_ids: torch.Tensor,
                      valid: torch.Tensor) -> None:
        """counts [B, V] += one-hot sums of token_ids [B, T] where valid
        (in place)."""
        counts.scatter_add_(1, token_ids.long(), valid.to(counts.dtype))

    def _forward(self, token_ids: torch.Tensor, q_start: torch.Tensor,
                 kv_len: torch.Tensor, kv_hi: Optional[int] = None
                 ) -> torch.Tensor:
        """``kv_hi``: the local log rows a cp prefill reads (its host
        mirror's written rows); None, as in decode, reads whole local logs
        (a graph replays one shape)."""
        if self.cp > 1:
            logits, _ = self._fwd(self.params, self.cache, token_ids, q_start,
                                  kv_len, kv_hi)
            return logits
        if self._fwd is not None:
            logits, _ = self._fwd(self.params, self.cache, token_ids, q_start,
                                  kv_len)
            return logits
        logits, self.cache = llama_model.forward_hidden(
            self.config, self.engine_config, self.params, token_ids,
            self.cache, q_start, kv_len)
        return logits

    # ------------------------------------------------------------------
    # paged-mode page management (host side; ops/paged_kv.py)
    # ------------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return self._allocator.free_pages if self.paged else 1 << 30

    def max_pool_tokens(self) -> int:
        """Largest context one request can EVER hold: max_seq_len, further
        capped by the whole paged pool (page 0 is reserved). The single
        source of truth for admission and rejection thresholds."""
        cap = self.engine_config.max_seq_len
        if self.paged:
            cap = min(cap, (self._allocator.num_pages - 1)
                      * self.engine_config.page_size)
        return cap

    def pages_needed(self, n_tokens: int) -> int:
        page = self.engine_config.page_size
        return -(-max(n_tokens, 0) // page)

    def _release_pages(self, slots: Sequence[int]) -> None:
        changed = False
        for b in slots:
            if self._slot_pages[b]:
                self._allocator.free(self._slot_pages[b])
                self._slot_pages[b] = []
                self._table_host[b, :] = 0
                changed = True
        if changed:
            self._upload_table()

    def adopt_prefix_pages(self, slot: int, pages: Sequence[int],
                           length: int) -> None:
        """Point a freshly reset slot's block table at SHARED read-only
        prefix pages (zero-copy prefix caching, runtime/prefix_cache.py):
        the allocator refcounts them, the slot's length starts at the
        shared token count, and all later writes land in the slot's own
        pages (length is a page multiple, so the chunk-alignment invariant
        holds)."""
        assert self.paged and not self._slot_pages[slot]
        assert length % self.engine_config.page_size == 0
        self._allocator.share(pages)
        self._slot_pages[slot] = list(pages)
        self._table_host[slot, :len(pages)] = pages
        self._upload_table()
        lengths = self._lengths.copy()
        lengths[slot] = length
        self._set_lengths(lengths)

    def take_slot_pages(self, slot: int, n: int) -> list[int]:
        """Transfer ownership of a slot's first ``n`` pages to the caller
        (prefix registration: the entry keeps them alive after the scratch
        slot resets). The slot keeps its remaining pages; the slot is
        reset right after, which rewrites its table row."""
        assert self.paged
        pages = self._slot_pages[slot][:n]
        self._slot_pages[slot] = self._slot_pages[slot][n:]
        return pages

    def ensure_capacity(self, targets) -> None:
        """Grow each slot's page list to cover ``targets`` [B] tokens
        (host-side allocator + block-table update). Raises MemoryError on
        pool exhaustion; callers (the scheduler) preempt on that."""
        if not self.paged:
            return
        changed = False
        for b, t in enumerate(np.asarray(targets)):
            need = self.pages_needed(int(t))
            have = len(self._slot_pages[b])
            if need > have:
                new = self._allocator.alloc(need - have)
                self._table_host[b, have:have + len(new)] = new
                self._slot_pages[b].extend(new)
                changed = True
        if changed:
            self._upload_table()

    def seed_counts(self, slot: int, ctx_tokens=None, gen_tokens=None):
        """Overwrite one slot's penalty-count rows from explicit token
        lists: bookkeeping for tokens that enter the context WITHOUT
        flowing through prefill/decode counting (a restored prefix's
        tokens; a preempted request's generated-so-far tokens on
        re-admission)."""
        V = self._counts_ctx.shape[1]

        def hist(tokens):
            h = np.bincount(np.asarray(tokens, np.int64), minlength=V)[:V]
            return self._dev(h)

        if ctx_tokens is not None:
            self._counts_ctx[slot] = hist(ctx_tokens)
        if gen_tokens is not None:
            self._counts_gen[slot] = hist(gen_tokens)

    # ------------------------------------------------------------------
    # low-level API
    # ------------------------------------------------------------------

    def reset(self, slots: Optional[Sequence[int]] = None):
        """Clear history (all slots, or specific ones); a paged slot's
        pages go back to the pool."""
        lengths = self._lengths.copy()
        if slots is None:
            rows = list(range(self.engine_config.max_batch_size))
            lengths[:] = 0
            self._counts_ctx.zero_()
            self._counts_gen.zero_()
        else:
            rows = list(slots)
            lengths[rows] = 0
            self._counts_ctx[rows] = 0
            self._counts_gen[rows] = 0
        if self.cp > 1:
            # the append logs carry state beyond the lengths (kv_pos, llen)
            reset_cp_cache(self.cache, rows)
            self._llen[rows] = 0
            self._lengths = lengths
            return
        self._set_lengths(lengths)
        if self.paged:
            self._release_pages(rows)

    def _advance_llen(self, active) -> None:
        """The host mirror of a cp decode step's ``llen`` update, by the
        device's rule (``parallel/cp_cache.cp_llen_after``): each active
        row's token goes to its least-full rank, ties to the lowest."""
        if self.cp > 1:
            rows = np.nonzero(np.asarray(active, bool))[0]
            self._llen[rows, np.argmin(self._llen[rows], axis=1)] += 1

    def prefill(self, prompts: Sequence[Sequence[int]],
                slots: Optional[Sequence[int]] = None,
                pad_to: Optional[int] = None) -> torch.Tensor:
        """Prefill prompt token ids into ``slots`` (default [0, len)).

        Appends to any existing history in those slots (multi-round). Slots
        not listed run with zero new tokens and are untouched. Prompts
        longer than ``max_prefill_len`` run as several chunks, each
        attending the cache its predecessors filled.

        ``pad_to``: the multi-host lockstep override
        (``runtime/multihost_scheduler.py``): every host runs the agreed
        chunk length and round count, whatever its own prompts (possibly
        none); the near-capacity split and bucket shrink are then skipped,
        as in the JAX package.

        Returns last-token logits [B, V] f32 (rows of untouched slots are
        don't-care)."""
        eng = self.engine_config
        B = eng.max_batch_size
        if slots is None:
            slots = list(range(len(prompts)))
        if len(prompts) > B or len(slots) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts > {B} slots"
                             if len(prompts) > B else
                             f"{len(slots)} slots for {len(prompts)} prompts")
        C = max(1, eng.max_prefill_len)
        max_len = max([len(p) for p in prompts] or [0])
        if pad_to is not None:
            max_len = max(max_len, pad_to)
        lengths_host = self._lengths.copy()
        cp = self.cp
        llen_host = self._llen.copy() if cp > 1 else None

        if pad_to is None and len(prompts) > 1:
            # near-capacity appends need a SMALLER padded bucket than fresh
            # admissions can share: run them as a separate call ("near" is
            # judged against the bucket this batch would use)
            T0 = _bucket_len(max((min(len(p), C) for p in prompts
                                  if len(p)), default=1), cap=C)
            near = [i for i, (sl, p) in enumerate(zip(slots, prompts))
                    if len(p) and lengths_host[sl] + T0 > eng.max_seq_len]
            if near and len(near) < sum(1 for p in prompts if len(p)):
                far = [i for i in range(len(prompts)) if i not in near]
                lg_far = self.prefill([prompts[i] for i in far],
                                      slots=[slots[i] for i in far])
                lg_near = self.prefill([prompts[i] for i in near],
                                       slots=[slots[i] for i in near])
                rows_near = np.zeros((B,), bool)
                rows_near[[slots[i] for i in near]] = True
                return torch.where(self._dev(rows_near, torch.bool)[:, None],
                                   lg_near, lg_far)

        final_logits = None
        offset = 0
        S = eng.max_seq_len
        s_local = S // cp
        while offset == 0 or offset < max_len:
            chunk_lens = np.zeros((B,), np.int32)
            chunk_max = 0
            for slot, p in zip(slots, prompts):
                n = min(max(len(p) - offset, 0), C)
                chunk_lens[slot] = n
                chunk_max = max(chunk_max, n)
            if pad_to is not None:
                chunk_max = max(chunk_max, min(max_len - offset, C))
            T = _bucket_len(max(chunk_max, 1), cap=C)
            # near capacity the PADDED window must not cross the cache
            # end (under cp, a rank's local log end): shrink the bucket
            # (down to an exact-fit tail bucket), and refuse loudly if the
            # real tokens cannot fit
            active_rows = chunk_lens > 0
            if pad_to is None and active_rows.any():
                qmax = int(lengths_host[active_rows].max())
                lmax = (int(llen_host[active_rows].max()) if cp > 1 else 0)

                def crosses(t):
                    return (qmax + t > S
                            or (cp > 1 and lmax + max(1, t // cp) > s_local))

                # floor: the real tokens, and under cp a >= 2-row chunk
                # per rank (T // cp == 1 would look like decode)
                t_floor = max(chunk_max, 2 * cp if cp > 1 else 1)
                while T > 1 and T // 2 >= t_floor and crosses(T):
                    T //= 2
                if crosses(T) and chunk_max <= S - qmax:
                    # exact-fit tail: room for the real tokens, but below
                    # any power-of-two bucket
                    fit = S - qmax
                    if cp > 1:
                        fit = min(fit, (s_local - lmax) * cp)
                        fit -= fit % cp
                    if fit >= t_floor and not crosses(fit):
                        T = fit
                if crosses(T):
                    raise ValueError(
                        f"prefill append at history {qmax} cannot fit a "
                        f"{T}-token padded chunk inside max_seq_len {S}"
                        + (f" (cp={cp}: a rank's local log is at "
                           f"{lmax}/{s_local})" if cp > 1 else "")
                        + "; the request exceeds the slot's remaining "
                        "capacity — raise max_seq_len or finish the slot")
            token_ids = np.zeros((B, T), np.int32)
            for slot, p in zip(slots, prompts):
                chunk = p[offset:offset + chunk_lens[slot]]
                token_ids[slot, :len(chunk)] = np.asarray(chunk, np.int32)

            if self.paged:
                # kernel H's chunk rows must start page-aligned:
                # multi-token writes start at a multiple of C (true for
                # prompts admitted from 0 or from a shared prefix;
                # multi-round appends at arbitrary history need the slot
                # layout)
                bad = (chunk_lens > 1) & (lengths_host % C != 0)
                if bad.any():
                    raise ValueError(
                        "paged KV: multi-token prefill must start at a "
                        f"multiple of max_prefill_len={C} (slots "
                        f"{np.nonzero(bad)[0].tolist()} are mid-page); "
                        "use kv_layout='slot' for arbitrary-offset appends")
                self.ensure_capacity(lengths_host + chunk_lens)
            kv_hi = None
            if llen_host is not None:
                # the append logs fill unevenly across ragged chunks (rank
                # 0 takes each chunk's head): mirror the llen update and
                # refuse before a local log overflows
                t_local = max(T // cp, 1)
                llen_host = llen_host + np.clip(
                    chunk_lens[:, None]
                    - np.arange(cp)[None, :] * t_local, 0, t_local)
                if (llen_host > s_local).any():
                    raise ValueError(
                        f"cp={cp}: a rank's local KV log would exceed "
                        f"its {s_local}-row capacity (ragged chunked "
                        "prefill skews fills toward rank 0); raise "
                        "max_seq_len or prefill in fewer, larger chunks")
                # the rows attention reads: the written ones, in whole
                # blocks of the CP attention
                kv_hi = round_up(int(llen_host.max()), BLOCK_KV)
                self._llen = llen_host.copy()
            ids = self._dev(token_ids)
            q_start = self.cache.lengths
            kv_len = self._dev(lengths_host + chunk_lens)
            valid = (torch.arange(T, device=self.device)[None, :]
                     < (kv_len - q_start)[:, None])
            self._count_tokens(self._counts_ctx, ids, valid)
            logits = self._forward(ids, q_start, kv_len, kv_hi)
            lengths_host = lengths_host + chunk_lens
            self._lengths = lengths_host.copy()

            if final_logits is None:
                final_logits = logits
            else:
                # a slot's logits come from the chunk holding its last token
                had = self._dev(chunk_lens > 0, torch.bool)
                final_logits = torch.where(had[:, None], logits, final_logits)
            offset += C
        return final_logits

    def _host_arrays(self, sp: SamplingParams):
        """Per-slot host arrays [B] (temperature, top_k, top_p) + the
        extras tuple (min_p, repetition, presence, frequency)."""
        B = self.engine_config.max_batch_size

        def full(v, dtype=np.float32):
            return np.full((B,), v, dtype)

        t = 0.0 if sp.greedy else sp.temperature
        extras = (full(sp.min_p), full(sp.repetition_penalty),
                  full(sp.presence_penalty), full(sp.frequency_penalty))
        return full(t), full(sp.top_k, np.int32), full(sp.top_p), extras

    def _penalized(self, logits, extras):
        _, rep, pres, freq = extras
        return apply_penalties(logits, self._counts_ctx, self._counts_gen,
                               rep, pres, freq)

    def _count_sampled(self, nxt, mask) -> None:
        self._count_tokens(self._counts_ctx, nxt[:, None], mask[:, None])
        self._count_tokens(self._counts_gen, nxt[:, None], mask[:, None])

    def _sample_and_count(self, logits, temp, topk, topp, extras,
                          count_mask: torch.Tensor):
        logits = self._penalized(logits, extras)
        nxt = sample_tokens(logits, self._gen, temp, topk, topp, extras[0])
        lp = token_logprobs(logits, nxt)
        self._count_sampled(nxt, count_mask)
        return nxt, lp

    def sample(self, logits, temperature, top_k, top_p, extras=None,
               count_mask=None, return_logprobs: bool = False):
        """Sample token ids from logits [B, V] with per-slot params [B].

        ``extras``: (min_p, repetition, presence, frequency) per-slot
        values (None = neutral). ``count_mask`` [B] bool marks rows whose
        sampled token enters the slot's penalty counts."""
        B = logits.shape[0]
        if extras is None:
            extras = tuple(np.full((B,), v, np.float32)
                           for v in _NEUTRAL_EXTRAS)
        mask = self._dev(np.zeros((B,), bool) if count_mask is None
                         else count_mask, torch.bool)
        nxt, lp = self._sample_and_count(
            logits, self._dev(temperature, torch.float32),
            self._dev(top_k, torch.int32), self._dev(top_p, torch.float32),
            tuple(self._dev(e, torch.float32) for e in extras), mask)
        return (nxt, lp) if return_logprobs else nxt

    # ------------------------------------------------------------------
    # device-side decode programs (runtime/decode_graph.py)
    # ------------------------------------------------------------------

    def _stage(self, tokens, active, arrays=None) -> None:
        """Fill the input buffer for the next program run: ``tokens`` and
        ``active`` [B], and the sampling ``arrays`` (temperature, top_k,
        top_p, extras; None keeps the rows as they are). Host values go in
        one copy from pinned memory; a value already on the card is copied
        on the card."""
        values = [tokens, active]
        if arrays is not None:
            temp, topk, topp, extras = arrays
            values += [temp, topk, topp, *extras]
        if self.device.type == "cuda":
            # the previous upload's copy must have left the pinned buffer
            self._input_copied.synchronize()
        on_card = []
        for row, v in enumerate(values):
            if isinstance(v, torch.Tensor) and v.device.type != "cpu":
                on_card.append((row, v))
            elif row in _FLOAT_ROWS:
                self._input_host[row].view(np.float32)[:] = np.asarray(
                    v, np.float32)
            else:
                self._input_host[row] = np.asarray(v).astype(np.int32)
        if self.device.type == "cuda":
            self._input_buf.copy_(self._input_pinned, non_blocking=True)
            self._input_copied.record()
        for row, v in on_card:
            dst = self._input_buf[row]
            (dst.view(torch.float32) if row in _FLOAT_ROWS else dst).copy_(v)

    def _run(self, name: str) -> None:
        """Run decode body ``name`` once: replay its graph on the card
        (captured at the first run), call it on the CPU."""
        # the warm-up runs with no row active; a rollout's step index and
        # carry are put back after it
        decode_graph.run(self, name, (self._input_buf, self._roll_i),
                         self._x.active, self._gen)

    def _step_body(self) -> None:
        """JAX ``_decode_step``: one step over all slots; rows with
        ``active`` 0 write no K/V and keep their length and counts."""
        x = self._x
        lengths = self.cache.lengths
        logits = self._forward(x.tokens[:, None], lengths,
                               lengths + x.active)
        nxt, lp = self._sample_and_count(logits, x.temperature, x.top_k,
                                         x.top_p, x.extras, x.active != 0)
        self._step_out[0].copy_(nxt)
        self._step_out[1].view(torch.float32).copy_(lp)

    def _greedy_body(self) -> None:
        """The scan body of JAX ``_decode_rollout``: greedy argmax, no
        penalties, every row advancing (``active`` is all ones; zeros only
        in the warm-up before a capture)."""
        x = self._x
        lengths = self.cache.lengths
        logits = self._forward(x.tokens[:, None], lengths,
                               lengths + x.active)
        nxt = greedy_sample(logits)
        x.tokens.copy_(nxt)
        self._roll_tok.index_copy_(0, self._roll_i, nxt[None])
        self._roll_i += 1

    def _sampled_body(self) -> None:
        """The while-loop body of JAX ``_sampled_rollout``: a row runs
        while ``active`` and below capacity; it emits its token (-1 once
        stopped) and stops after a stop id."""
        x = self._x
        lengths = self.cache.lengths
        act = (x.active != 0) & (lengths < self.engine_config.max_seq_len - 1)
        logits = self._forward(x.tokens[:, None], lengths,
                               lengths + act.to(torch.int32))
        logits = self._penalized(logits, x.extras)
        nxt = sample_tokens(logits, self._gen, x.temperature, x.top_k,
                            x.top_p, x.extras[0])
        nxt = torch.where(act, nxt, x.tokens)
        lp = token_logprobs(logits, nxt)
        self._count_sampled(nxt, act)
        self._roll_tok.index_copy_(0, self._roll_i,
                                   torch.where(act, nxt, -1)[None])
        self._roll_lp.index_copy_(0, self._roll_i, lp[None])
        self._roll_i += 1
        x.tokens.copy_(nxt)
        x.active.copy_(act & ~self._stop_mask[nxt.long()])
        self._roll_flag.copy_(x.active.amax(0, keepdim=True) != 0)

    def decode_step(self, tokens, active, sp_or_arrays,
                    return_logprobs: bool = False):
        """One decode step over all slots. tokens: [B] int tensor or array;
        active: [B] bool (host). ``sp_or_arrays``: a SamplingParams or a
        (temperature, top_k, top_p[, extras]) tuple of per-slot [B]
        values (host arrays or tensors)."""
        if isinstance(sp_or_arrays, SamplingParams):
            arrays = self._host_arrays(sp_or_arrays)
        else:
            temp, topk, topp, *rest = sp_or_arrays
            arrays = (temp, topk, topp,
                      tuple(rest[0]) if rest else _NEUTRAL_EXTRAS)
        active_host = np.asarray(active, bool)
        self.ensure_capacity(self._lengths + active_host)
        self._stage(tokens, active_host, arrays)
        self._run("step")
        self._advance_llen(active_host)
        self._lengths = self._lengths + active_host.astype(np.int32)
        out = self._step_out.clone()
        nxt, lp = out[0], out[1].view(torch.float32)
        return (nxt, lp) if return_logprobs else nxt

    def decode_rollout(self, tokens, num_steps: int) -> torch.Tensor:
        """Greedy decode ``num_steps`` tokens for all slots in one device
        program replayed ``num_steps`` times (JAX's ``lax.scan``). Returns
        [num_steps, B] int32 token ids on the engine's device."""
        B, S = self.engine_config.max_batch_size, self.engine_config.max_seq_len
        if num_steps > S:
            raise ValueError(f"decode_rollout of {num_steps} steps: more "
                             f"than max_seq_len {S}")
        # a paged rollout reserves its pages up front, as the JAX
        # package's device-side loop must
        self.ensure_capacity(self._lengths + num_steps)
        self._stage(tokens, np.ones((B,), np.int32))
        self._roll_i.zero_()
        for _ in range(num_steps):
            self._run("greedy")
            self._advance_llen(np.ones((B,), bool))
        self._lengths = self._lengths + num_steps
        return self._roll_tok[:num_steps].clone()

    def _sampled_rollout(self, tokens, active, stop_ids, arrays,
                         steps: int):
        """JAX ``_sampled_rollout``: up to ``steps`` sampled steps from
        ``tokens`` for the ``active`` rows, stop ids and capacity checked
        on the device, the host stopping once a flag read says no row is
        active. Returns host (tokens [n, B], -1 where a row did not run;
        logprobs [n, B]) for the n steps run, and refreshes the host
        mirror of the lengths in the same copy."""
        B, S = self.engine_config.max_batch_size, self.engine_config.max_seq_len
        V = self.config.vocab_size
        stop = np.zeros((V,), bool)
        stop[[t for t in stop_ids if 0 <= t < V]] = True
        self._stop_mask.copy_(self._dev(stop, torch.bool))
        self._stage(tokens, active, arrays)
        self._roll_i.zero_()
        # a row runs at most S - 1 steps before it reaches capacity
        n = min(steps, S)
        # a tap dumps every step: stop where the JAX while-loop stops
        tapped = debug.tap.enabled
        for done in range(1, n + 1):
            self._run("sampled")
            if not (bool(self._roll_flag.any()) if tapped
                    else self._flags.running(done)):
                n = done
                break
        host = torch.cat([self._roll_tok[:n].flatten(),
                          self._roll_lp[:n].view(torch.int32).flatten(),
                          self.cache.lengths]).cpu().numpy()
        self._lengths = host[2 * n * B:].copy()
        for row in host[:n * B].reshape(n, B):
            self._advance_llen(row >= 0)       # the rows that ran the step
        return (host[:n * B].reshape(n, B),
                host[n * B:2 * n * B].view(np.float32).reshape(n, B))

    # ------------------------------------------------------------------
    # generation loop
    # ------------------------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: SamplingParams = SamplingParams(),
                 eos_token_id: int | None = 2,
                 stream_callback: Optional[Callable[[int, int], None]] = None
                 ) -> GenerationResult:
        """Generate completions for up to max_batch_size prompts, appended
        to the slots' history. stream_callback(seq_index, token_id) fires
        per generated token; without one, the tail after the first token
        runs as one device-side sampled rollout."""
        nseq = len(prompts)
        B = self.engine_config.max_batch_size

        first_logits = self.prefill(prompts)
        arrays = self._host_arrays(sampling)
        tokens, first_lp = self.sample(first_logits, *arrays[:3],
                                       extras=arrays[3],
                                       count_mask=np.arange(B) < nseq,
                                       return_logprobs=True)
        tok_host = tokens.cpu().numpy()
        lp_host = first_lp.cpu().numpy()

        stop_ids = set(sampling.stop_token_ids)
        if eos_token_id is not None:
            stop_ids.add(eos_token_id)

        out: list[list[int]] = [[] for _ in range(nseq)]
        lp_out: list[list[float]] = [[] for _ in range(nseq)]
        done = np.zeros((B,), bool)
        done[nseq:] = True

        def emit(i, t, lp):
            if t in stop_ids:
                done[i] = True
                return
            out[i].append(t)
            lp_out[i].append(lp)
            if stream_callback:
                stream_callback(i, t)

        for i in range(nseq):
            emit(i, int(tok_host[i]), float(lp_host[i]))

        max_room = self.engine_config.max_seq_len - 1
        steps = sampling.max_new_tokens - 1
        if stream_callback is None and steps > 0 and not done.all():
            # the whole tail in one device-side rollout, its worst case
            # reserved first: MemoryError here, before the first step
            self.ensure_capacity(np.minimum(
                self._lengths + np.where(done, 0, steps), max_room + 1))
            rolled, rolled_lp = self._sampled_rollout(
                tok_host, ~done, stop_ids, arrays, steps)
            for row, lp_row in zip(rolled, rolled_lp):
                for i in range(nseq):
                    if not done[i] and row[i] >= 0:
                        emit(i, int(row[i]), float(lp_row[i]))
        else:
            for _ in range(steps):
                # a row at capacity never advances again: it stays inactive
                active = ~done & (self._lengths < max_room)
                if not active.any():
                    break
                tokens, step_lp = self.decode_step(tokens, active, arrays,
                                                   return_logprobs=True)
                tok_host = tokens.cpu().numpy()
                lp_host = step_lp.cpu().numpy()
                for i in range(nseq):
                    if active[i]:
                        emit(i, int(tok_host[i]), float(lp_host[i]))

        # A length-terminated row's FINAL sampled token was never fed back,
        # so its K/V is absent from the cache; top it up with a one-token
        # prefill so multi-round appends see the full conversation.
        # EOS-terminated rows are complete already. The length test uses
        # this round's prompt only, as the JAX package does (so it fires in
        # a slot's first round; ROADMAP.md queue 3).
        pending = [i for i in range(nseq)
                   if out[i] and not done[i]
                   and self._lengths[i] == len(prompts[i]) + len(out[i]) - 1]
        if pending:
            self.prefill([[out[i][-1]] for i in pending], slots=pending)
            # the token was counted when sampled; undo the prefill's
            # context-count increment
            self._counts_ctx[pending, [out[i][-1] for i in pending]] -= 1

        return GenerationResult(
            token_ids=out,
            num_prompt_tokens=[len(p) for p in prompts],
            num_generated=[len(o) for o in out],
            logprobs=lp_out,
        )
