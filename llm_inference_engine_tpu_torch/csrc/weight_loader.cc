// Native weight loader: mmap'd tensor reads with multithreaded dtype
// conversion and [out, in] -> [in, out] transposition.
//
// C++ equivalent of the reference's weight-loading tier (reference:
// src/utils/weight_utils.cu:132-229 — a serial fread per tensor followed by
// an H2D copy and, for dtype mismatches, a `typeConversion` CUDA cast
// kernel at weight_utils.cu:46-60). On TPU the H2D transfer belongs to JAX
// (jnp.asarray / device_put); what remains host-side — and dominates
// checkpoint load time for a 7B model — is reading tens of GB and
// reshaping fp16/bf16 [out, in] matrices into the engine's [in, out]
// layout. That work is embarrassingly parallel and memory-bound, so it is
// done here with pread into the caller's buffer and a blocked, threaded
// cast/transpose.
//
// Consumed via ctypes from llm_inference_engine_tpu_torch/native.py and
// runtime/native_io.py (the PyTorch port's copy of the JAX package's
// csrc/weight_loader.cc).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__unix__) || defined(__APPLE__)
#include <fcntl.h>
#include <unistd.h>
#define LLM_HAVE_PREAD 1
#endif

namespace {

// dtype codes shared with the Python side.
enum DType : int32_t {
  kF32 = 0,
  kF16 = 1,
  kBF16 = 2,
  kI8 = 3,
};

inline int64_t ItemSize(int32_t dt) { return dt == kF32 ? 4 : dt == kI8 ? 1 : 2; }

inline float F16ToF32(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int e = -1;
      do {
        ++e;
        man <<= 1;
      } while (!(man & 0x400));
      bits = sign | ((127 - 15 - e) << 23) | ((man & 0x3FF) << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline float BF16ToF32(uint16_t h) {
  uint32_t bits = static_cast<uint32_t>(h) << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t F32ToBF16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  if (((bits >> 23) & 0xFF) == 0xFF && (bits & 0x7FFFFFu))
    return static_cast<uint16_t>((bits >> 16) | 0x40u);  // quiet the nan
  // round-to-nearest-even
  uint32_t lsb = (bits >> 16) & 1;
  bits += 0x7FFFu + lsb;
  return static_cast<uint16_t>(bits >> 16);
}

inline uint16_t F32ToF16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((x >> 23) & 0xFF) - 127 + 15;
  uint32_t man = x & 0x7FFFFFu;
  if (((x >> 23) & 0xFF) == 0xFF)  // inf / nan: preserve nan payload bit
    return static_cast<uint16_t>(sign | 0x7C00u | (man ? 0x200u : 0));
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);
    man |= 0x800000u;
    uint32_t shift = 14 - exp;
    uint32_t half = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    half += (rem > (1u << (shift - 1))) ||
            (rem == (1u << (shift - 1)) && (half & 1));
    return static_cast<uint16_t>(sign | half);
  }
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);
  uint32_t half = (exp << 10) | (man >> 13);
  uint32_t rem = man & 0x1FFFu;
  half += (rem > 0x1000u) || (rem == 0x1000u && (half & 1));
  return static_cast<uint16_t>(sign | half);
}

inline float LoadAs(const uint8_t* p, int32_t dt) {
  switch (dt) {
    case kF32: {
      float f;
      std::memcpy(&f, p, 4);
      return f;
    }
    case kF16: {
      uint16_t h;
      std::memcpy(&h, p, 2);
      return F16ToF32(h);
    }
    case kBF16: {
      uint16_t h;
      std::memcpy(&h, p, 2);
      return BF16ToF32(h);
    }
    default:
      return static_cast<float>(*reinterpret_cast<const int8_t*>(p));
  }
}

inline void StoreAs(uint8_t* p, int32_t dt, float v) {
  switch (dt) {
    case kF32:
      std::memcpy(p, &v, 4);
      break;
    case kF16: {
      uint16_t h = F32ToF16(v);
      std::memcpy(p, &h, 2);
      break;
    }
    case kBF16: {
      uint16_t h = F32ToBF16(v);
      std::memcpy(p, &h, 2);
      break;
    }
    default:
      *reinterpret_cast<int8_t*>(p) = static_cast<int8_t>(v);
  }
}

int NumThreads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

template <typename Fn>
void ParallelFor(int64_t n, Fn fn) {
  int threads = NumThreads();
  if (n < 2 || threads < 2) {
    fn(0, n);
    return;
  }
  if (threads > n) threads = static_cast<int>(n);
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Read `nbytes` at `offset` from `path` into `out`. Parallel pread in
// chunks (page-cache friendly). Returns 0 on success, -1 on IO error.
int32_t llm_read_file(const char* path, int64_t offset, int64_t nbytes,
                      uint8_t* out) {
#ifdef LLM_HAVE_PREAD
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  std::atomic<int32_t> err{0};
  ParallelFor((nbytes + (8 << 20) - 1) / (8 << 20), [&](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      int64_t start = c * (8 << 20);
      int64_t len = nbytes - start < (8 << 20) ? nbytes - start : (8 << 20);
      int64_t done = 0;
      while (done < len) {
        ssize_t r = pread(fd, out + start + done, len - done,
                          offset + start + done);
        if (r <= 0) {
          err.store(-1);
          return;
        }
        done += r;
      }
    }
  });
  close(fd);
  return err.load();
#else
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  size_t r = std::fread(out, 1, static_cast<size_t>(nbytes), f);
  std::fclose(f);
  return r == static_cast<size_t>(nbytes) ? 0 : -1;
#endif
}

// Cast `n` elements src(dt_in) -> dst(dt_out), threaded.
// (The reference's typeConversion kernel, weight_utils.cu:46-60, host-side.)
void llm_cast(const uint8_t* src, int32_t dt_in, uint8_t* dst, int32_t dt_out,
              int64_t n) {
  if (dt_in == dt_out) {
    std::memcpy(dst, src, static_cast<size_t>(n * ItemSize(dt_in)));
    return;
  }
  int64_t in_sz = ItemSize(dt_in), out_sz = ItemSize(dt_out);
  ParallelFor((n + 65535) / 65536, [&](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      int64_t s = c * 65536;
      int64_t e = s + 65536 < n ? s + 65536 : n;
      for (int64_t i = s; i < e; ++i)
        StoreAs(dst + i * out_sz, dt_out, LoadAs(src + i * in_sz, dt_in));
    }
  });
}

// dst[j, i] = cast(src[i, j]) for src [rows, cols] -> dst [cols, rows],
// blocked 64x64 for cache locality, threaded over row blocks. This is the
// HF [out, in] -> engine [in, out] canonicalization done natively.
void llm_transpose_cast(const uint8_t* src, int32_t dt_in, uint8_t* dst,
                        int32_t dt_out, int64_t rows, int64_t cols) {
  const int64_t B = 64;
  int64_t in_sz = ItemSize(dt_in), out_sz = ItemSize(dt_out);
  int64_t row_blocks = (rows + B - 1) / B;
  ParallelFor(row_blocks, [&](int64_t lo, int64_t hi) {
    for (int64_t rb = lo; rb < hi; ++rb) {
      int64_t r0 = rb * B;
      int64_t r1 = r0 + B < rows ? r0 + B : rows;
      for (int64_t c0 = 0; c0 < cols; c0 += B) {
        int64_t c1 = c0 + B < cols ? c0 + B : cols;
        for (int64_t i = r0; i < r1; ++i) {
          const uint8_t* srow = src + (i * cols) * in_sz;
          for (int64_t j = c0; j < c1; ++j) {
            StoreAs(dst + (j * rows + i) * out_sz, dt_out,
                    LoadAs(srow + j * in_sz, dt_in));
          }
        }
      }
    }
  });
}

}  // extern "C"
