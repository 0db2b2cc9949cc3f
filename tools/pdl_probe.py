#!/usr/bin/env python3
"""Does a programmatic dependent launch (PDL) survive CUDA-graph capture?

    python3 tools/pdl_probe.py

Builds two toy kernels with nvcc (into ``build/pdl_probe/``) and runs
them on one CUDA card. ``first`` lets its dependents launch at once, then
spins for ~20 us and writes ``a[i] = i + 1``; ``second`` records the
card's clock when its block starts, waits in ``griddepcontrol.wait``,
then writes ``b[i] = 2 * a[i]``. ``second`` is launched through
``cudaLaunchKernelEx`` with ``cudaLaunchAttributeProgrammaticStreamSerialization``
set to 1 (and, as the control, 0). Each pair runs eagerly and as a replay
of a ``torch.cuda.graph`` capture. For each run the script prints whether
``b`` is right, how far ``second`` started before ``first`` ended (the
card's global timer, ns: positive = overlap), and, for the replays, the
two kernels' intervals under torch.profiler. The last line is one JSON
object with the same figures. It fails where there is no card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = r"""
#include <cuda_runtime.h>
__device__ unsigned long long now() {
  unsigned long long t; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); return t;
}
__global__ void first(int* a, unsigned long long* t_end, long long spin_ns) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const unsigned long long t0 = now();
  while (now() - t0 < (unsigned long long)spin_ns) {}
  a[blockIdx.x * blockDim.x + threadIdx.x] = blockIdx.x * blockDim.x + threadIdx.x + 1;
  __syncthreads();
  if (threadIdx.x == 0) t_end[blockIdx.x] = now();
}
__global__ void second(const int* a, int* b, unsigned long long* t_start) {
  if (threadIdx.x == 0) t_start[blockIdx.x] = now();
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  b[i] = 2 * a[i];
}
extern "C" int pair(int* a, int* b, unsigned long long* t_end,
                    unsigned long long* t_start, int blocks, int pdl,
                    void* stream) {
  first<<<blocks, 128, 0, (cudaStream_t)stream>>>(a, t_end, 20000);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks); cfg.blockDim = dim3(128); cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl;
  cfg.attrs = attr; cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, second, (const int*)a, b, t_start);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
"""


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from llm_inference_engine_tpu_torch.ops import _native
    out = ROOT / "build" / "pdl_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SOURCE)
    subprocess.run([_native.nvcc_path(), *_native.NVCC_FLAGS, "-shared",
                    "-o", str(out / "libprobe.so"), str(out / "probe.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out / "libprobe.so"))
    lib.pair.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    return lib


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("pdl_probe: no CUDA device")
    lib = build()
    blocks = 8
    a, b = (torch.zeros(blocks * 128, dtype=torch.int32, device="cuda")
            for _ in range(2))
    t_end, t_start = (torch.zeros(blocks, dtype=torch.int64, device="cuda")
                      for _ in range(2))
    want = 2 * torch.arange(1, blocks * 128 + 1, device="cuda",
                            dtype=torch.int32)

    def run(pdl):
        a.zero_()
        b.zero_()
        status = lib.pair(a.data_ptr(), b.data_ptr(), t_end.data_ptr(),
                          t_start.data_ptr(), blocks, pdl,
                          torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"pdl_probe: launch failed, cudaError {status}")

    def lead_ns():
        return int(t_end.max().item() - t_start.min().item())

    result = {}
    for pdl in (1, 0):
        run(pdl)
        torch.cuda.synchronize()
        eager = dict(correct=bool(torch.equal(b, want)), lead_ns=lead_ns())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run(pdl)
        graph.replay()
        torch.cuda.synchronize()
        replay = dict(correct=bool(torch.equal(b, want)), lead_ns=lead_ns())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.name in ("first", "second")
                       or e.name.startswith(("first(", "second(")))
        replay["profiler_us"] = [(n.split("(")[0], round(s, 3), round(e, 3))
                                 for s, e, n in spans]
        if len(spans) == 2:
            replay["profiler_overlap_us"] = round(spans[0][1] - spans[1][0],
                                                  3)
        result[f"pdl={pdl}"] = dict(eager=eager, replay=replay)
        print(f"programmaticStreamSerializationAllowed={pdl}: eager {eager}; "
              f"graph replay {replay}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps(dict(card=smi, torch=torch.__version__,
                          cuda=torch.version.cuda, **result)))
    ok = all(r[m]["correct"] for r in result.values()
             for m in ("eager", "replay"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
