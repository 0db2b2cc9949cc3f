"""Device-side decode of the port (``runtime/decode_graph.py``) against the
JAX package, on the CPU.

On a card the engine captures its three decode bodies (the step, the
greedy rollout step, the sampled rollout step) into CUDA graphs and
replays them; on the CPU it runs the same bodies eagerly, so these tests
hold the bodies and the host protocol around them (staging, the rollout
index, the early-exit flag, the host mirror of the lengths) against the
JAX engine's ``decode_rollout`` and ``generate`` on the debug preset, with
the JAX dummy weights crossed over by ``params_from_numpy``. A body that
reads a device value on the host could not be captured:
``NoHostReads`` is the CPU proxy for that. The replays themselves run in
``tests/test_torch_kernels.py`` on the card.
"""

import jax
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.config import EngineConfig as JEngineConfig
from llm_inference_engine_tpu.config import SamplingParams as JSamplingParams
from llm_inference_engine_tpu.config import get_config as j_get_config
from llm_inference_engine_tpu.models.weights import (
    init_dummy_params as j_init_dummy_params)
from llm_inference_engine_tpu.runtime.engine import (
    InferenceEngine as JInferenceEngine)

from llm_inference_engine_tpu_torch.config import (
    EngineConfig, SamplingParams, get_config)
from llm_inference_engine_tpu_torch.models.registry import create_engine
from llm_inference_engine_tpu_torch.models.weights import params_from_numpy
from llm_inference_engine_tpu_torch.runtime.decode_graph import (
    FLAG_EVERY, HostReadError, NoHostReads)
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

# slot, paged (chunks of 8 in pages of 16), int8 slot cache (absmax
# scales on the CPU, as the JAX package's CPU cache)
LAYOUTS = {"slot": dict(max_prefill_len=16),
           "paged": dict(kv_layout="paged", page_size=16, max_prefill_len=8),
           "int8": dict(max_prefill_len=16, kv_cache_dtype_name="int8")}
# logprobs: the same f32 math on both sides, summed in another order
LP_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jp = j_init_dummy_params(j_get_config("debug"), seed=7)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _engines(weights, layout, **kw):
    kw = dict(max_batch_size=3, max_seq_len=64, **LAYOUTS[layout], **kw)
    return (JInferenceEngine(j_get_config("debug"),
                             JEngineConfig(kernels="xla", **kw), weights[0]),
            InferenceEngine(get_config("debug"), EngineConfig(**kw),
                            weights[1]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_rollout_matches_jax(weights, layout):
    """Greedy rollouts of 13 and then 6 steps (neither a multiple of the
    flag interval) after a ragged prefill: ids and lengths equal."""
    je, te = _engines(weights, layout)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 256, n).tolist() for n in (4, 21, 9)]
    first_j = np.asarray(je.prefill(prompts)).argmax(-1).astype(np.int32)
    first_t = te.prefill(prompts).argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(first_t.numpy(), first_j)
    toks_j, toks_t = first_j, first_t
    for steps in (13, 6):
        rj = np.asarray(je.decode_rollout(toks_j, steps))
        rt = te.decode_rollout(toks_t, steps)
        assert rt.shape == (steps, 3)
        np.testing.assert_array_equal(rt.numpy(), rj)
        np.testing.assert_array_equal(te.cache.lengths.numpy(),
                                      np.asarray(je.cache.lengths))
        np.testing.assert_array_equal(te._lengths, te.cache.lengths.numpy())
        toks_j, toks_t = rj[-1], rt[-1]


def _check_generate(rj, rt, je, te):
    assert rt.token_ids == rj.token_ids
    assert rt.num_generated == rj.num_generated
    for lt, lj in zip(rt.logprobs, rj.logprobs):
        np.testing.assert_allclose(lt, lj, atol=LP_ATOL)
    np.testing.assert_array_equal(te.cache.lengths.numpy(),
                                  np.asarray(je.cache.lengths))
    np.testing.assert_array_equal(te._lengths, te.cache.lengths.numpy())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_generate_tail_matches_jax(weights, layout):
    """``generate``'s non-streaming tail, greedy, over two prompts in three
    slots (one slot inactive): row 0's 56-token prompt reaches
    max_seq_len - 1 after 7 tail steps (capacity, on the device); 11 new
    tokens are 10 tail steps under a 16-step bucket (a dynamic limit).
    Then again with a stop id taken from row 1's tokens of the first run,
    so row 1 stops mid-tail. Ids, counts, logprobs and final lengths
    equal the JAX engine's."""
    je, te = _engines(weights, layout)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 256, n).tolist() for n in (56, 13)]
    sp = dict(greedy=True, max_new_tokens=11)
    rj = je.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
    rt = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
    _check_generate(rj, rt, je, te)
    # row 0 stopped at capacity (its last token topped up to 64), row 1
    # ran to the limit
    assert rt.num_generated == [8, 11]
    assert te.cache.lengths.tolist() == [64, 13 + 11, 0]

    row = rt.token_ids[1]
    cut = next(i for i in range(3, 10) if row[i] not in row[:i])
    stop = row[cut]
    for e in (je, te):
        e.reset()
    sp["stop_token_ids"] = (stop,)
    rj = je.generate(prompts, JSamplingParams(**sp), eos_token_id=None)
    rt = te.generate(prompts, SamplingParams(**sp), eos_token_id=None)
    _check_generate(rj, rt, je, te)
    assert rt.token_ids[1] == row[:cut]


@pytest.mark.parametrize("layout", [*LAYOUTS, "int4"])
def test_decode_bodies_read_nothing_on_the_host(layout):
    """One run of each decode body (step, greedy rollout step, sampled
    rollout step) under NoHostReads, with penalties and sampling on: none
    reads a device value on the host, so each can be captured. int4: the
    plain versions of the quantized matmuls."""
    kw = (dict(quant_mode="int4", quant_group_size=64) if layout == "int4"
          else LAYOUTS[layout])
    e = create_engine("debug", None,
                      EngineConfig(max_batch_size=3, max_seq_len=64, **kw),
                      device="cpu")
    e.prefill([[5, 6, 7], [8] * 8, [9, 10]])
    sp = SamplingParams(temperature=0.7, top_k=4, top_p=0.9, min_p=0.05,
                        repetition_penalty=1.2, presence_penalty=0.5,
                        frequency_penalty=0.25)
    e._stage(np.array([1, 2, 3]), np.array([1, 1, 0]), e._host_arrays(sp))
    e.ensure_capacity(e._lengths + 3)
    for name in ("step", "greedy", "sampled"):
        with NoHostReads(name):
            getattr(e, f"_{name}_body")()
    assert e._roll_i.tolist() == [2]
    assert e.cache.lengths.tolist() == [3 + 3, 8 + 3, 2]


@pytest.mark.parametrize("read", ["item", "bool", "mask", "nonzero",
                                  "to_cpu", "from_host"])
def test_no_host_reads_names_the_op(read):
    """The guard the capture runs under raises on each kind of host read,
    naming the op and the program."""
    x = torch.arange(6.0)
    reads = {"item": lambda: x.sum().item(),
             "bool": lambda: bool(x.any()),
             "mask": lambda: x[x > 2],
             "nonzero": lambda: torch.nonzero(x),
             "to_cpu": lambda: x.to("cpu", copy=True),
             "from_host": lambda: torch.tensor([1, 2])}
    with pytest.raises(HostReadError, match="decode program 'probe': aten"):
        with NoHostReads("probe"):
            reads[read]()


def test_sampled_rollout_stops_reading_after_every_row_stopped():
    """The early exit: with every row stopped by a stop id after its first
    tail step, the host stops replaying within two flag intervals (the
    flag read lags one interval) instead of running max_new_tokens - 1
    steps; the lengths advance by that one step."""
    e = create_engine("debug", None,
                      EngineConfig(max_batch_size=2, max_seq_len=256),
                      device="cpu")
    prompts = [[5, 6, 7], [9, 10]]
    sp = SamplingParams(greedy=True, max_new_tokens=3)
    ref = e.generate(prompts, sp, eos_token_id=None).token_ids
    e.reset()
    stops = {t[1] for t in ref}
    # each row up to its first stop id
    want = [t[:next(i for i, x in enumerate(t) if x in stops)] for t in ref]
    runs = []
    run = e._run
    e._run = lambda name: (runs.append(name), run(name))
    r = e.generate(prompts, SamplingParams(greedy=True, max_new_tokens=200,
                                           stop_token_ids=tuple(stops)),
                   eos_token_id=None)
    assert r.token_ids == want
    assert 1 <= len(runs) <= 2 * FLAG_EVERY
    assert e.cache.lengths.tolist() == [len(p) + len(w)
                                        for p, w in zip(prompts, want)]
