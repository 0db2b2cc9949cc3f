"""Prefix snapshots, speculation and beam search of the PyTorch port over
a dp x tp mesh, against the JAX package's mesh engines.

The JAX engines run on the conftest's virtual CPU devices, built once per
module and mesh (their compiles are what cost time); the port's meshes
are copies of the CPU device. On the ``debug`` preset at f32, for (dp, tp)
in (1, 2), (2, 1), (2, 2): the scheduler's greedy ids with a slot
``PrefixStore`` (a bf16 and an int8 cache) equal JAX's, and every
restored row of every shard equals its snapshot bit for bit, a restore
into another data group's slot included; ``SpeculativeDecoder.generate``
greedy ids and counts equal JAX's, and a sampled round's processed
distributions (the draft's q and the verify's p) within 1e-5 of JAX's on
the same tokens; ``SpeculativeScheduler`` with a ``DualPrefixStore``
equal to JAX's; ``beam_search`` over the engine's ``ShardedParams``
(and over a cp = 2 engine's) with JAX's sequences and scores within
1e-5; the round, the ingest and the beam step under ``NoHostReads`` (the
CPU proxy for a capturable program); the CLI's ``--tp 2 --beams 2``; and
what stays refused: the paged pool's slot store, engines on two meshes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models import llama as j_llama
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.ops import sampling as j_sampling
from llm_inference_engine_tpu.parallel import make_mesh as j_make_mesh
from llm_inference_engine_tpu.runtime.beam_search import (
    beam_search as j_beam_search)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)
from llm_inference_engine_tpu.runtime.scheduler import (
    ContinuousBatchingScheduler as JScheduler)
from llm_inference_engine_tpu.runtime.speculative_scheduler import (
    SpeculativeScheduler as JSpeculativeScheduler)
from llm_inference_engine_tpu_torch import cli
from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models.weights import (
    init_dummy_params, params_from_numpy)
from llm_inference_engine_tpu_torch.parallel import make_mesh
from llm_inference_engine_tpu_torch.runtime import speculative
from llm_inference_engine_tpu_torch.runtime.beam_search import (
    BeamSearch, beam_search)
from llm_inference_engine_tpu_torch.runtime.decode_graph import NoHostReads
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.prefix_cache import (
    PagedPrefixStore, PrefixStore, restore_prefix, snapshot_prefix)
from llm_inference_engine_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)
from llm_inference_engine_tpu_torch.runtime.speculative import (
    SpeculativeDecoder)
from llm_inference_engine_tpu_torch.runtime.speculative_scheduler import (
    SpeculativeScheduler)
from test_torch_session import _repl

CFG_J = j_get_config("debug")        # 4 heads, 2 kv heads, vocab 256, f32
CFG = get_config("debug")
MESHES = [(1, 2), (2, 1), (2, 2)]
CPU = torch.device("cpu")
TOL = 1e-5
KW = dict(max_batch_size=4, max_seq_len=128)
K_DRAFT = 3
NEW = 6
# a 9-token shared prefix (a snapshot of one RESTORE_BUCKET, 64 rows,
# whose pad rows the tails and the new tokens overwrite) and four tails:
# every prefill is one chunk of the 16-row bucket, so that each JAX engine
# compiles one prefill program
PREFIX = list(range(3, 12))
TAILS = [list(range(100, 107)), [7, 8, 9], [50, 51, 52, 53], [60]]


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _weights(seed):
    """(JAX params, port params) of the debug preset from one seed: 0 the
    target, 5 the draft."""
    jp = j_init_dummy_params(CFG_J, seed=seed)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@functools.cache
def _jax_engine(seed, dp, tp, cp=1, kv=""):
    """The module's JAX engine of one mesh and cache, built once and reset
    by each user."""
    mesh = (j_make_mesh(dp=dp, tp=tp, cp=cp, devices=jax.devices("cpu"))
            if cp == 1 else None)
    eng = JEngineConfig(kernels="xla", kv_cache_dtype_name=kv, cp=cp,
                        **({"max_prefill_len": 16} if cp > 1 else {}), **KW)
    return JInferenceEngine(CFG_J, eng, _weights(seed)[0], mesh=mesh)


def _jax(seed, dp, tp, cp=1, kv=""):
    e = _jax_engine(seed, dp, tp, cp, kv)
    e.reset()
    return e


@functools.cache
def _jax_spec(dp, tp):
    """The module's JAX speculative scheduler of one mesh (target seed 0,
    draft seed 5); its decoder (``_spec``) also serves ``generate``, so
    that its round compiles once."""
    return JSpeculativeScheduler(_jax(0, dp, tp), _jax(5, dp, tp),
                                 eos_token_id=None, num_draft=K_DRAFT)


def _port(seed, dp, tp, cp=1, kv=""):
    n = dp * tp * cp
    eng = EngineConfig(kv_cache_dtype_name=kv,
                       **({"max_prefill_len": 16} if cp > 1 else {}), **KW)
    return InferenceEngine(CFG, eng, _weights(seed)[1],
                           mesh=make_mesh(dp, tp, cp, devices=[CPU] * n))


def _prompts():
    return [PREFIX + t for t in TAILS]


def _greedy(sp_cls):
    return sp_cls(greedy=True, max_new_tokens=NEW)


def _serve(sched, sp_cls):
    reqs = [sched.submit(p, _greedy(sp_cls)) for p in _prompts()]
    sched.run()
    return [r.output_ids for r in reqs], [r.reused_prefix_len for r in reqs]


def _rows_equal(cache, slot, entry) -> bool:
    """Every shard of ``slot``'s data group holds its part of ``entry`` bit
    for bit (values and an int8 cache's scale planes), and the length."""
    row, shards = cache.slot_shards(slot)
    ok = int(cache.lengths[slot]) == entry.length
    for shard, part in zip(shards, entry.parts):
        n = part.padded_length
        for name in ("k", "v", "k_scale", "v_scale"):
            got, want = getattr(shard, name), getattr(part, name)
            if want is not None:
                ok &= torch.equal(got[:, row, :n], want)
    return ok


# ---------------------------------------------------------------------------
# the slot PrefixStore over a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["", "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_prefix_store_ids_and_rows_match_jax(dp, tp, kv):
    """The scheduler with a registered prefix: greedy ids and reused
    lengths equal the JAX mesh scheduler's (a cache in the model dtype and
    an int8 one); the snapshot holds one part a model rank at the rank's
    local heads; restored into a slot of every data group (a copy between
    groups where dp = 2), every shard's rows equal their part bit for
    bit."""
    je = _jax(0, dp, tp, kv=kv)
    js = JScheduler(je, eos_token_id=None)
    js.register_prefix(PREFIX)
    want = _serve(js, JSamplingParams)

    te = _port(0, dp, tp, kv=kv)
    ts = ContinuousBatchingScheduler(te, eos_token_id=None)
    entry = ts.register_prefix(PREFIX)
    assert len(entry.parts) == tp and entry.length == len(PREFIX)
    assert entry.parts[0].k.shape[2] == CFG.num_kv_heads // tp
    assert (entry.parts[0].k_scale is not None) == (kv == "int8")
    assert _serve(ts, SamplingParams) == want
    assert want[1] == [len(PREFIX)] * 4
    te.reset()
    for slot in range(KW["max_batch_size"]):
        ts.prefix_store.restore(slot, entry)
        assert te._lengths[slot] == len(PREFIX)
        assert _rows_equal(te.cache, slot, entry)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_bf16_prefix_store_restores_bit_for_bit(dp, tp):
    """A bf16 cache, a bf16 model's (a float cache takes the model's
    dtype whatever its name, as the JAX engine allocates it): a snapshot
    taken in each data group restores into every slot bit for bit, shard
    by shard, and the scheduler's greedy ids with the store equal those
    without it."""
    cfg = CFG.replace(dtype_name="bfloat16")
    te = InferenceEngine(cfg, EngineConfig(kv_cache_dtype_name="bfloat16",
                                           **KW),
                         init_dummy_params(cfg, seed=0, device="cpu"),
                         mesh=make_mesh(dp, tp, devices=[CPU] * (dp * tp)))
    base = _serve(ContinuousBatchingScheduler(te, eos_token_id=None),
                  SamplingParams)
    te.reset()
    ts = ContinuousBatchingScheduler(te, eos_token_id=None)
    store = ts.prefix_store = PrefixStore(te)
    B = KW["max_batch_size"]
    entries = [store.register(PREFIX, slot=0),
               store.register(PREFIX[:-1], slot=B - 1)]
    assert entries[0].parts[0].k.dtype == torch.bfloat16
    for entry in entries:
        for slot in range(B):
            store.restore(slot, entry)
            assert _rows_equal(te.cache, slot, entry)
    te.reset()
    store.evict(PREFIX[:-1])
    ids, reused = _serve(ts, SamplingParams)
    assert ids == base[0] and reused == [len(PREFIX)] * 4


def test_prefix_restore_across_data_groups_matches_a_prefill():
    """dp = 2 x tp = 2: a snapshot of slot 0 (data group 0) restored into
    slot 3 (data group 1), then a tail prefilled there, gives the logits
    of the whole prompt prefilled into slot 3 (f32: the same sums in the
    same order, within 1e-5); the restored lengths are global."""
    te = _port(0, 2, 2)
    te.prefill([PREFIX], slots=[0])
    entry = snapshot_prefix(te.cache, 0, len(PREFIX))
    te.reset()
    restore_prefix(te.cache, 3, entry)
    te._set_lengths([0, 0, 0, len(PREFIX)])
    assert _rows_equal(te.cache, 3, entry)
    got = te.prefill([TAILS[1]], slots=[3])
    te.reset()
    want = te.prefill([PREFIX + TAILS[1]], slots=[3])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                               rtol=TOL)


def test_slot_store_refuses_a_mesh_pool_and_a_one_device_entry():
    """A paged mesh engine: the slot store refuses (the page-pool message)
    and the paged prefix store works over its table and allocator; a
    snapshot of one device's cache does not restore into a mesh's."""
    jp = _weights(0)[1]
    paged = InferenceEngine(CFG, EngineConfig(
        tp=2, kv_layout="paged", page_size=16, max_prefill_len=8, **KW), jp,
        device=CPU)
    with pytest.raises(NotImplementedError, match="slot KV layout"):
        PrefixStore(paged)
    entry = PagedPrefixStore(paged).register(list(range(3, 40)))
    assert entry.length == 32 and len(entry.pages) == 2
    one = InferenceEngine(CFG, EngineConfig(**KW), jp, device=CPU)
    one.prefill([PREFIX])
    entry = snapshot_prefix(one.cache, 0, len(PREFIX))
    with pytest.raises(ValueError, match="does not match"):
        restore_prefix(_port(0, 1, 2).cache, 0, entry)


# ---------------------------------------------------------------------------
# speculative decoding over a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", MESHES)
def test_speculative_decoder_matches_jax(dp, tp):
    """Target and draft on the same mesh: greedy ids, drafted and accepted
    counts equal the JAX decoder's over its mesh engines."""
    want = _jax_spec(dp, tp)._spec.generate(_prompts(), NEW,
                                            eos_token_id=None)
    spec = SpeculativeDecoder(_port(0, dp, tp), _port(5, dp, tp), K_DRAFT)
    got = spec.generate(_prompts(), NEW, eos_token_id=None)
    assert got.token_ids == [list(map(int, t)) for t in want.token_ids]
    assert (got.num_drafted, got.num_accepted) == (want.num_drafted,
                                                   want.num_accepted)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_sampled_round_probs_match_jax(dp, tp, monkeypatch):
    """One sampled round over the mesh (temperature 0.8, top-k 20, top-p
    0.9): the draft's q at each of its k steps and the verify's p at each
    of the k + 1 positions within 1e-5 of JAX's processed distributions
    over its mesh engines' forwards on the same tokens."""
    seen = {}

    def recording(draft_toks, q, p, gen):
        seen.update(drafts=draft_toks.clone(), q=q.clone(), p=p.clone())
        return accept(draft_toks, q, p, gen)
    accept = speculative.speculative_accept
    monkeypatch.setattr(speculative, "speculative_accept", recording)
    te, td = _port(0, dp, tp), _port(5, dp, tp)
    spec = SpeculativeDecoder(te, td, K_DRAFT, rng_seed=3)
    prompts = _prompts()
    te.prefill(prompts)
    td.prefill(prompts)
    B = KW["max_batch_size"]
    last = np.array([11, 22, 33, 44], np.int32)
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
    spec.run_round(last, np.ones(B, bool), te._host_arrays(sp), True)

    je, jd = _jax(0, dp, tp), _jax(5, dp, tp)
    je.prefill(prompts)
    jd.prefill(prompts)
    temp, topk, topp = (jnp.full((B,), 0.8), jnp.full((B,), 20, jnp.int32),
                        jnp.full((B,), 0.9))
    drafts = jnp.asarray(seen["drafts"].numpy())
    lens = je.cache.lengths
    tok = jnp.asarray(last)
    cache = jd.cache
    step = jax.jit(functools.partial(j_llama.forward_hidden, CFG_J,
                                     jd.engine_config))
    for i in range(K_DRAFT):
        q_start = cache.lengths
        logits, cache = step(jd.params, tok[:, None], cache, q_start,
                             q_start + 1)
        q = j_sampling.processed_probs(logits, temp, topk, topp)
        np.testing.assert_allclose(seen["q"][:, i].numpy(), np.asarray(q),
                                   atol=TOL, rtol=TOL)
        tok = drafts[:, i]
    block = jnp.concatenate([jnp.asarray(last)[:, None], drafts], axis=1)
    verify = jax.jit(functools.partial(j_llama.forward_all_logits, CFG_J,
                                       je.engine_config))
    logits, _ = verify(je.params, block, je.cache, lens,
                       lens + K_DRAFT + 1)
    T = K_DRAFT + 1
    p = j_sampling.processed_probs(
        logits, jnp.broadcast_to(temp[:, None], (B, T)),
        jnp.broadcast_to(topk[:, None], (B, T)),
        jnp.broadcast_to(topp[:, None], (B, T)))
    np.testing.assert_allclose(seen["p"].numpy(), np.asarray(p), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_speculative_scheduler_dual_prefix_matches_jax(dp, tp):
    """SpeculativeScheduler over a target and a draft on one mesh, with a
    registered prefix (a DualPrefixStore: paired snapshots, one part a
    model rank in each engine): ids and reused lengths equal the JAX
    speculative scheduler's; a pair restored into the last slot is exact
    in both engines."""
    js = _jax_spec(dp, tp)
    js.register_prefix(PREFIX)
    want = _serve(js, JSamplingParams)
    te, td = _port(0, dp, tp), _port(5, dp, tp)
    ts = SpeculativeScheduler(te, td, eos_token_id=None, num_draft=K_DRAFT)
    entry = ts.register_prefix(PREFIX)
    assert _serve(ts, SamplingParams) == want
    te.reset()
    td.reset()
    ts.prefix_store.restore(3, entry)
    assert _rows_equal(te.cache, 3, entry.target)
    assert _rows_equal(td.cache, 3, entry.draft)
    assert te._lengths[3] == td._lengths[3] == len(PREFIX)


def test_speculation_refuses_engines_on_two_meshes_or_a_paged_engine():
    te, td = _port(0, 1, 2), _port(5, 2, 1)
    with pytest.raises(ValueError, match=r"target on mesh data=1 model=2 "
                       r"over \['cpu', 'cpu'\], draft on mesh data=2 "
                       "model=1"):
        SpeculativeDecoder(te, td)
    one = InferenceEngine(CFG, EngineConfig(**KW), _weights(5)[1],
                          device=CPU)
    with pytest.raises(ValueError, match="draft on cpu"):
        SpeculativeDecoder(te, one)
    paged = InferenceEngine(CFG, EngineConfig(
        tp=2, kv_layout="paged", page_size=16, max_prefill_len=8, **KW),
        _weights(0)[1], device=CPU)
    # the JAX messages
    with pytest.raises(NotImplementedError,
                       match="speculative scheduling uses the slot KV"):
        SpeculativeScheduler(paged, te)
    with pytest.raises(ValueError, match="max_batch_size mismatch"):
        SpeculativeScheduler(te, InferenceEngine(
            CFG, EngineConfig(max_batch_size=2, max_seq_len=128, tp=2),
            _weights(5)[1], device=CPU))


# ---------------------------------------------------------------------------
# beam search over sharded params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp,cp", [(1, 2, 1), (2, 1, 1), (2, 2, 1),
                                      (1, 1, 2)])
def test_beam_search_over_sharded_params_matches_jax(dp, tp, cp):
    """beam_search over a mesh engine's ShardedParams (a cp = 2 engine's
    among them): JAX's sequences over the same engine's params, scores
    within 1e-5; the search runs on data group 0's model ranks, each
    holding its kv heads of every beam."""
    je = _jax(0, dp, tp, cp)
    te = _port(0, dp, tp, cp)
    prompt = PREFIX + TAILS[2]
    want = j_beam_search(CFG_J, je.engine_config, je.params, prompt,
                         num_beams=3, max_new_tokens=NEW, eos_token_id=None)
    got = beam_search(CFG, te.engine_config, te.params, prompt, num_beams=3,
                      max_new_tokens=NEW, eos_token_id=None)
    assert got.sequences == want.sequences
    np.testing.assert_allclose(got.scores, want.scores, atol=TOL, rtol=TOL)
    bs = BeamSearch(CFG, te.engine_config, te.params, 3)
    assert bs.mesh.shape == {"data": 1, "model": tp}
    assert [s.k.shape[3] for row in bs.cache.shards for s in row] == (
        [CFG.num_kv_heads // tp] * tp)


# ---------------------------------------------------------------------------
# the device programs, and the CLI
# ---------------------------------------------------------------------------

def test_mesh_round_ingest_and_beam_step_read_nothing_on_the_host():
    """dp = 2 x tp = 2: the greedy and the sampled round (one row
    inactive, penalties on), the ingest and a beam step (int8 beam cache)
    under NoHostReads: on one card they are captured as CUDA graphs."""
    te, td = _port(0, 2, 2), _port(5, 2, 2)
    spec = SpeculativeDecoder(te, td, K_DRAFT)
    te.prefill(_prompts())
    td.prefill(_prompts())
    arrays = te._host_arrays(SamplingParams(temperature=0.7, top_k=5,
                                            repetition_penalty=1.2))
    te._stage(np.array([5, 6, 7, 8]), np.array([1, 1, 0, 1], bool), arrays)
    for name in ("greedy", "sampled", "ingest"):
        with NoHostReads(name):
            getattr(spec, f"_{name}_body")()
    bs = BeamSearch(CFG, te.engine_config.replace(
        kv_cache_dtype_name="int8"), te.params, 2)
    bs.search(PREFIX, 2, eos_token_id=None)
    with NoHostReads("beam step"):
        bs._step_body()


def test_cli_tp2_beams_answers_a_turn(monkeypatch, capsys):
    """``--device cpu --tp 2 --beams 2``: ChatSession.response_beam over the
    mesh engine answers two turns with the one-rank CLI's replies (the
    dummy weights are the port's own, so the JAX CLI's differ; the
    one-rank session is held against the JAX one in
    ``test_torch_session.py``)."""
    argv = ["--model", "debug", "--dummy-weights", "--max-new-tokens", "4",
            "--max-seq-len", "64", "--beams", "2", "--device", "cpu"]
    stdin = "7 11 13\n5 6\ns\n"
    got = _repl(cli.main, argv + ["--tp", "2"], stdin, monkeypatch, capsys)
    want = _repl(cli.main, argv, stdin, monkeypatch, capsys)
    reply = got.split("ready.", 1)[1]
    assert reply == want.split("ready.", 1)[1]
    assert reply.count("please input the question: :") == 2
