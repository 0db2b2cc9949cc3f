"""Kernel E's fragment mode, on the CPU: the fragment order of INT4
weights (``ops.quant.repack_int4_decode`` and its inverse) and the plain
version over it, against the port's ``int4_matmul_torch`` and the JAX
package's ``_int4_matmul_kernel`` (its Pallas path in interpret mode, as
the JAX tests run it; conftest sets interpret mode).

Tolerances: the repack, its inverse and every view of it bit for bit;
the plain version over the repacked weight bit for bit the plain version
over q (the same function after the inverse); against the JAX kernel,
f32 outputs within 1e-5 of the output's largest magnitude (the same f32
products summed in another order), bf16 outputs 2e-2 (one rounding of
the output plus that order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_engine_tpu.ops import quant as j_quant

from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
from llm_inference_engine_tpu_torch.models.registry import create_engine
from llm_inference_engine_tpu_torch.ops import quant
from llm_inference_engine_tpu_torch.parallel.sharding import ShardedParams

MODELS = ["llama2-7b", "llama3.1-8b", "mistral-7b", "qwen2-7b", "llama2-13b",
          "tinyllama-1.1b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def _torch_threads():
    """Few torch threads: the suite runs beside JAX in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _projections(name: str, tp: int):
    """(label, k, n, halves) of a preset's INT4 matmuls on one rank of
    ``tp`` (column shards split n, row shards k; the gate|up stack keeps
    both halves)."""
    cfg = get_config(name)
    H, I = cfg.hidden_size, cfg.intermediate_size
    return [("wqkv", H, cfg.qkv_size // tp, 1), ("wo", cfg.q_size // tp, H, 1),
            ("gate|up", H, I // tp, 2), ("down", I // tp, H, 1),
            ("lm_head", H, cfg.vocab_size // tp, 1)]


def _packed(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-128, 128, size=shape,
                                         dtype=np.int8))


def _round_trip(q: torch.Tensor) -> None:
    qd = quant.repack_int4_decode(q)
    assert qd.shape == q.shape and qd.dtype == torch.int8
    assert torch.equal(quant.unpack_int4_decode(qd), q)
    # a permutation: the same nibbles, each as often
    nib = lambda t: torch.stack([t.view(torch.uint8) & 15,
                                 t.view(torch.uint8) >> 4]).flatten()
    assert torch.equal(torch.bincount(nib(qd), minlength=16),
                       torch.bincount(nib(q), minlength=16))


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("model", MODELS)
def test_repack_round_trips_at_the_presets_widths(rng, model, tp):
    """Every INT4 matmul of the preset on one rank of tp: all of its K
    rows (k/2 stored rows by 48 columns) and all of its columns (64 stored
    rows by n), in the gate|up stack's [2, k/2, I] form where it is one,
    bit for bit through the repack and its inverse."""
    for label, k, n, halves in _projections(model, tp):
        lead = (2,) if halves == 2 else ()
        assert k % 64 == 0 and n % 16 == 0, (label, k, n)
        _round_trip(_packed(rng, *lead, k // 2, 48))
        _round_trip(_packed(rng, *lead, 64, n))


def _reference_order(q: np.ndarray) -> np.ndarray:
    """The fragment order written out lane by lane (independent of the
    port's reshapes): for tile T (16 columns), chunk c (64 K rows), lane
    4g + t and k16 step j, one 32-bit word whose register i (0..3) holds
    K rows 64c + 16j + 2t + 8 (i >> 1) and + 1 of column 16T + 2g + (i &
    1), at bits 4i and 16 + 4i."""
    k2, n = q.shape
    vals = np.empty((2 * k2, n), np.int64)
    b = q.view(np.uint8).astype(np.int64)
    vals[0::2], vals[1::2] = b & 15, b >> 4
    out = bytearray()
    for T in range(n // 16):
        for c in range(2 * k2 // 64):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for j in range(4):
                    w = 0
                    for i in range(4):
                        col = 16 * T + 2 * g + (i & 1)
                        row = 64 * c + 16 * j + 2 * t + 8 * (i >> 1)
                        w |= int(vals[row, col]) << (4 * i)
                        w |= int(vals[row + 1, col]) << (16 + 4 * i)
                    out += w.to_bytes(4, "little")
    return np.frombuffer(bytes(out), np.int8).reshape(k2, n)


@pytest.mark.parametrize("k,n", [(64, 16), (128, 48), (256, 32)])
def test_repack_is_the_fragment_order(rng, k, n):
    """The bytes of the repack, word for word, against the order written
    out lane by lane."""
    q = _packed(rng, k // 2, n)
    assert np.array_equal(quant.repack_int4_decode(q).numpy(),
                          _reference_order(q.numpy()))


def test_layer_stacks_repack_matrix_by_matrix(rng):
    """A layer stack of the gate|up stack [L, 2, k/2, I]: each matrix
    repacked on its own, and ``t[layer]`` gives its layer's view of qd,
    which is that layer's repack."""
    q = _packed(rng, 3, 2, 128, 80)
    t = quant.QuantizedTensor(q, torch.ones(3, 2, 2, 80), "int4", 128)
    t.qd = quant.repack_int4_decode(t.q)
    for layer in range(3):
        view = t[layer]
        assert view.qd.data_ptr() == t.qd[layer].data_ptr()
        for h in range(2):
            assert torch.equal(view.qd[h], quant.repack_int4_decode(q[layer, h]))
    _round_trip(q)


def test_repack_refuses_shapes_outside_its_tiles():
    """K rows not a multiple of 64 or columns not of 16 have no fragment
    order; neither has a non-int8 tensor."""
    for bad in (torch.zeros(16, 32, dtype=torch.int8),       # k = 32
                torch.zeros(32, 40, dtype=torch.int8),       # n = 40
                torch.zeros(32, 32, dtype=torch.uint8)):
        with pytest.raises(ValueError):
            quant.repack_int4_decode(bad)


def _weight(rng, k, n, group, halves=1):
    """(float weight, JAX QuantizedTensor, port QuantizedTensor with qd)."""
    shape = (2, k, n) if halves == 2 else (k, n)
    w = (rng.normal(size=shape) * 0.02).astype(np.float32)
    jts = [j_quant.quantize_tensor(jnp.asarray(wh), "int4", group)
           for wh in (w if halves == 2 else [w])]
    q = np.stack([np.asarray(j.q) for j in jts]) if halves == 2 else \
        np.asarray(jts[0].q)
    s = np.stack([np.asarray(j.scale) for j in jts]) if halves == 2 else \
        np.asarray(jts[0].scale)
    t = quant.QuantizedTensor(torch.from_numpy(q.copy()),
                              torch.from_numpy(s.copy()), "int4", group)
    t.qd = quant.repack_int4_decode(t.q)
    return jts, t


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 16])
def test_plain_decode_version_is_int4_matmul_torch(rng, m, group):
    """The fragment mode's plain version over qd, bit for bit the plain
    version of kernel E over q (bf16 and f32 outputs, a ragged m)."""
    _, t = _weight(rng, 512, 96, group)
    x = torch.from_numpy(rng.normal(size=(m, 512)).astype(np.float32))
    for dt, out in ((torch.bfloat16, torch.bfloat16),
                    (torch.bfloat16, torch.float32),
                    (torch.float32, torch.float32)):
        got = quant.int4_matmul_decode_torch(x.to(dt), t.qd, t.scale, group,
                                             out)
        want = quant.int4_matmul_torch(x.to(dt), t.q, t.scale, group, out)
        assert got.dtype == out and torch.equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("m", [1, 4, 8, 16])
def test_plain_decode_version_matches_jax_kernel(rng, m, group, dtype):
    """x [m, k] times a K of 5 groups of 128 (10 of 64) by 80 columns:
    the plain version over the fragment order against the JAX package's
    ``_int4_matmul_kernel`` (``quantized_linear``, kernels="pallas")."""
    jdt, tdt, tol = DTYPES[dtype]
    k, n = 640, 80
    jts, t = _weight(rng, k, n, group)
    x = rng.normal(size=(m, k)).astype(np.float32)
    want = j_quant.quantized_linear(jnp.asarray(x, jdt), jts[0],
                                    kernels="pallas")
    got = quant.int4_matmul_decode_torch(torch.from_numpy(x).to(tdt), t.qd,
                                         t.scale, group, tdt)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_gate_up_stack_over_the_fragment_order_matches_jax(rng):
    """One layer of the gate|up stack [2, k/2, I], both halves in one call
    (flat [m, gate | up] out), against the JAX kernel half by half."""
    k, n = 512, 96
    jts, t = _weight(rng, k, n, 128, halves=2)
    x = rng.normal(size=(8, k)).astype(np.float32)
    got = quant.int4_matmul_decode_torch(torch.from_numpy(x), t.qd, t.scale,
                                         128, torch.float32)
    want = np.concatenate([np.asarray(j_quant.quantized_linear(
        jnp.asarray(x), j, kernels="pallas")) for j in jts], axis=-1)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert got.shape == (8, 2 * n) and err <= 1e-5, err


def test_quantized_tensor_carries_its_fragment_order(rng):
    """``qd`` rides along where it stays valid: layer views, and ``to``
    the device the weight is on already (the weight itself); it is
    dropped by column and row shards (a shard builds its own) and on the
    way to a device other than a card."""
    q = _packed(rng, 2, 64, 64)
    t = quant.QuantizedTensor(q, torch.ones(2, 1, 64), "int4", 128)
    assert t.qd is None and t[0].qd is None
    t.qd = quant.repack_int4_decode(q)
    assert torch.equal(t[1].qd, t.qd[1])
    assert t.columns(0, 32).qd is None and t.rows(0, 128).qd is None
    assert t.to("cpu") is t
    assert t.to("meta").qd is None
    assert t.nbytes == q.numel() + 2 * 64 * 4   # q and scales: qd not counted


def test_fragment_mode_needs_the_layout():
    """The wrapper's check, which the CPU reaches: at the fragment mode's
    m (<= 16, INT4 groups of 64 or 128, a bf16 or float16 x) a missing
    qd raises, naming the function that builds it; a qd of another shape
    raises; float32 x, m 17 and group 256 never read one."""
    q = torch.zeros(256, 64, dtype=torch.int8)
    for dtype in (torch.bfloat16, torch.float16):
        x = torch.zeros(8, 512, dtype=dtype)
        with pytest.raises(ValueError, match="add_decode_layout"):
            quant._check_layout("int4_matmul", x, q, None, 128)
        with pytest.raises(ValueError, match="qd must be"):
            quant._check_layout("int4_matmul", x, q, q[:128], 128)
        assert quant._check_layout("int4_matmul", x, q,
                                   quant.repack_int4_decode(q), 128) != 0
        assert quant._check_layout("int4_matmul", torch.zeros(
            17, 512, dtype=dtype), q, None, 128) == 0
        assert quant._check_layout("int4_matmul", x, q, None, 256) == 0
    assert quant._check_layout("int4_matmul", torch.zeros(8, 512), q, None,
                               128) == 0


def _quantized_leaves(tree):
    if isinstance(tree, quant.QuantizedTensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _quantized_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _quantized_leaves(v)]
    return []


@pytest.mark.parametrize("tp", [1, 2])
def test_cpu_engine_builds_no_layout(tp):
    """A CPU engine (one device or a tp = 2 mesh of CPUs) keeps q alone:
    the fragment order is built on the card only; the builder leaves CPU
    weights as they are."""
    # debug at twice its widths in bf16: every INT4 shard holds whole
    # groups of 64, a group the fragment mode takes
    cfg = get_config("debug").replace(hidden_size=128, intermediate_size=256,
                                      head_dim=32, dtype_name="bfloat16")
    eng = EngineConfig(max_batch_size=2, max_seq_len=64, quant_mode="int4",
                       quant_group_size=64, tp=tp)
    engine = create_engine(cfg, None, eng, device="cpu")
    params = engine.params
    tree = params.grid if isinstance(params, ShardedParams) else params
    leaves = _quantized_leaves(tree)
    assert leaves and all(t.qd is None for t in leaves)
    quant.add_decode_layouts(tree, torch.bfloat16)
    assert all(t.qd is None for t in leaves)
    assert not any(quant.needs_decode_layout(t, torch.bfloat16)
                   for t in leaves)
