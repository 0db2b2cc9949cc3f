"""The attention launches of the PyTorch port, on the CPU: every C entry
point of kernels D2 and D (bf16) and of their float16 / float32 instances
D2f and Df (the same entry points with the dtype's suffix,
``_native.ATTENTION_SUFFIX``) receives its arguments in the order of its
C parameters, each by name in its place.

A recording stand-in takes the library's place; the expected value of
each parameter follows from its name in ``csrc/attention_*.cu`` (the
tensors' data pointers, the shapes, the scale, the window). The kernels
themselves run only on the card (``tests/test_torch_kernels.py``).
"""

import re

import pytest
import torch

from llm_inference_engine_tpu_torch.ops import _native, attention

B, T, H, K, D, L = 3, 5, 8, 2, 64, 2
S, P, PAGE, MAXP = 40, 9, 16, 3

# entry point: (pool, int8 cache, new rows, decode (T = 1), snapped)
ENTRIES = {
    "attention_prefill": (False, False, False, False, None),
    "attention_prefill_paged": (True, False, False, False, None),
    "attention_prefill_int8": (False, True, False, False, None),
    "attention_prefill_paged_int8": (True, True, False, False, None),
    "attention_decode": (False, False, True, True, None),
    "attention_decode_int8": (False, True, True, True, True),
    "attention_decode_paged_fused": (True, False, True, True, None),
    "attention_decode_paged": (True, False, False, True, None),
    "attention_decode_paged_int8": (True, True, False, True, None),
    "attention_decode_paged_fused_int8": (True, True, True, True, None),
}


def _c_params(name):
    """The parameter names of ``extern "C" int name(...)`` in csrc/*.cu."""
    for src in sorted(_native.CSRC.glob("*.cu")):
        m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)',
                      src.read_text())
        if m:
            return [p.split()[-1].lstrip("*")
                    for p in m.group(1).split(",")]
    raise AssertionError(f"{name} is defined in no csrc/*.cu")


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_launch_passes_each_c_parameter_in_its_place(monkeypatch, entry,
                                                     dtype):
    paged, int8, new_rows, decode, snapped = ENTRIES[entry]
    rec = _Recorder()
    monkeypatch.setattr(_native, "library", lambda: rec)
    monkeypatch.setattr(_native, "stream_of", lambda t: 12345)
    T_ = 1 if decode else T
    q = torch.zeros(B, T_, H, D, dtype=dtype)
    shape = (L, P, PAGE, K, D) if paged else (L, B, S, K, D)
    kv_dtype = torch.int8 if int8 else dtype
    k, v = torch.zeros(shape, dtype=kv_dtype), torch.zeros(shape,
                                                           dtype=kv_dtype)
    kw = {}
    if int8:
        kw.update(k_scale=torch.ones(shape[:-1]),
                  v_scale=torch.ones(shape[:-1]))
    if paged:
        kw["table"] = torch.zeros(B, MAXP, dtype=torch.int32)
    if new_rows:
        kw.update(k_new=torch.zeros(B, 1, K, D, dtype=dtype),
                  v_new=torch.zeros(B, 1, K, D, dtype=dtype))
    if snapped is not None:
        kw["snapped"] = snapped
    q_start = torch.zeros(B, dtype=torch.int32)
    kv_len = torch.ones(B, dtype=torch.int32)
    out = attention._launch(entry, q, k, v, q_start, kv_len, 1,
                            sm_scale=0.25, window=7, **kw)
    suffix = _native.ATTENTION_SUFFIX[str(dtype).split(".")[-1]]
    (name, args), = rec.calls
    assert name == entry + suffix
    params = _c_params(name)
    assert len(params) == len(args) == len(_native._SIGNATURES[name])
    want = dict(q=q.data_ptr(), k_cache=k.data_ptr(), v_cache=v.data_ptr(),
                k_pool=k.data_ptr(), v_pool=v.data_ptr(),
                out=out.data_ptr(), q_start=q_start.data_ptr(),
                kv_len=kv_len.data_ptr(), layer=1, B=B, T=T_, H=H, K=K,
                S=S, P=P, page=PAGE, max_pages=MAXP, D=D, sm_scale=0.25,
                window=7, snapped=int(bool(snapped)), stream=12345)
    for t in ("k_scale", "v_scale", "table", "k_new", "v_new"):
        if t in kw:
            want[t] = kw[t].data_ptr()
    assert dict(zip(params, args)) == {p: want[p] for p in params}
    assert out.shape == q.shape and out.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=str)
def test_float_paged_fused_decode_counts_its_own_launcher(monkeypatch,
                                                          dtype):
    """A float16 or float32 q on the fused paged decode runs Df's entry
    point of its dtype and counts on ``attention_decode_paged_fused_float``,
    not on the bf16 kernel's counter."""
    rec = _Recorder()
    monkeypatch.setattr(_native, "library", lambda: rec)
    monkeypatch.setattr(_native, "stream_of", lambda t: 0)
    monkeypatch.setattr(attention, "use_kernel", lambda kernels, t: True)
    q = torch.zeros(B, 1, H, D, dtype=dtype)
    pool = torch.zeros(L, P, PAGE, K, D, dtype=dtype)
    new = torch.zeros(B, 1, K, D, dtype=dtype)
    lens = torch.ones(B, dtype=torch.int32)
    table = torch.zeros(B, MAXP, dtype=torch.int32)
    fused = attention.attention_decode_paged_fused_float.launches
    bf16 = attention.attention_decode_paged_fused.launches
    out, kp, vp = attention.attention_decode_paged_fused(
        q, new, new, pool, pool.clone(), lens - 1, lens, 0, table=table)
    assert kp is pool and out.dtype == dtype
    assert [n for n, _ in rec.calls] == [
        "attention_decode_paged_fused"
        + _native.ATTENTION_SUFFIX[str(dtype).split(".")[-1]]]
    assert attention.attention_decode_paged_fused_float.launches == fused + 1
    assert attention.attention_decode_paged_fused.launches == bf16
