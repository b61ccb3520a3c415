// ZipCache's cache-store quantization for Hopper, sm_90a: K channelwise and
// V CSTQuant (paper Alg. 1) in one launch per store.
//
// Replaces src/repro/kernels/cst_quant/kernel.py::cst_quantize_pallas (body
// _cst_quant_kernel) and, on the live path, the store quantizer around it,
// src/repro/core/kvcache.py::_quantize_kv under the zipcache policy
// (quant.quantize_channelwise for K, quant.quantize_cst for V), with the
// gather of the store's tokens and its zero rows fused in.
//
// One store of S slots: slot r of batch row b reads source token idx[b, r]
// of K and V (b, hk, l, d), or a zero row where idx < 0 (a store's padding,
// an invalid slot at recompression).  Per (b, kv head):
//   K: per channel over the S slots, scale = max((max - min) / qmax, 1e-8),
//      zero = round(-min / scale); codes = clip(round(x / scale + zero));
//   V: c = sqrt(max(colmax |x|, 1e-8)); per slot over the channels of
//      xn = x / c the same (scale, zero) and codes of xn.
// qmax is 2**bits - 1, or, where the host passes a per-slice table of
// effective bits (a precision map or a downshift rung: whole bits, 1 to
// `bits`), 2**eff - 1 for the (b, kv head, tensor) of the slice, computed
// exactly in integers: scale, zero and the clip all take it, and the codes
// stay packed at `bits`.
// Codes pack 8 / bits fields LSB-first into a byte; scale, zero and c are
// written in the store dtype (the sources' dtype), rounded to nearest even.
// The arithmetic is the reference's in the same order: IEEE division and
// square root, rintf (half to even), so the codes and parameters equal
// core.quant's bit for bit.  Never build this file with --use_fast_math.
//
// Bound on the H100: bytes.  Each source element is read once and leaves
// as bits / 8 bytes of code.  In between, a column statistic needs every
// slot before the first code, so the slice is read twice, and each element
// takes one (K) or two (V) IEEE divisions, whose latency sets the time at
// these sizes.  The design:
//   - grid (split, 2 * hk, b) of 512-thread CTAs: CTA (x, t, b) takes a
//     contiguous run of ceil(S / split) slots of tensor t (K heads, then V
//     heads) of batch row b; with split > 1 the slice's CTAs form a
//     thread-block cluster (split 1, one CTA per slice, is the baseline the
//     wrapper can still ask for);
//   - the CTA stages its run in shared memory: the slot indices first, then
//     16-byte cp.async gathers of the rows (an index < 0 is zero-filled by
//     the copy), so the source is read from device memory once; a run that
//     does not fit (long caches, f32 sources) is staged in chunks and read
//     twice;
//   - pass 1, the column statistics (K min and max, V abs max): each thread
//     owns 8 channels of a row (4 at 8 bits), one 16- or 32-bit word of
//     codes, up to a warp per row (256 channels, 128 at 8 bits); a wider
//     row (MLA's 512-wide latent) gives each thread M = 2 or 4 such words,
//     so that a warp still owns a row; shuffles fold a warp's rows, then
//     the warps in order; a
//     cluster's CTAs read each other's statistics through distributed
//     shared memory (min / max are order-free; no atomics) and arrive on
//     the cluster barrier they wait on only at the end;
//   - pass 2 from shared memory: K codes from the channel parameters; V
//     divides by c, finds the slot's min / max with shuffles across the
//     row's threads, and codes; a zero slot (index < 0) takes its codes and
//     parameters without a division; each thread stores its word of codes,
//     a warp a coalesced run of code rows.
// The one-tensor call (cst_quant_rows, the TPU kernel's counterpart) is
// the V instantiation with c given, f32 parameters and no gather: pass 2
// alone, over runs of rows in chunks.  A store with an eff table is its own
// instantiation (HAS_EFF): one scalar load per CTA, the same arithmetic
// with the slice's qmax in place of the constant; without a table the
// constant folds as before.  A launch whose rows all fit a warp at one word
// a thread is the MMAX = 1 instantiation (two CTAs an SM); one with a wider
// tensor is MMAX = 2 or 4, whose CTAs pick the body of their tensor's
// multiplier (one CTA an SM, up to 128 registers a thread).  The min / max
// reductions are exact in any order, so the codes and parameters are the
// same bits at every multiplier.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr float EPS = 1e-8f;

// One store call as the host describes it (ctypes mirrors this layout).
// Tensor t: 0 = K, 1 = V.
struct StoreDesc {
  const void* src[2];       // (b, hk, l, d[t]) bf16 / f32, channel stride 1
  const int* idx;           // (b, S) int32 source token of each slot, < 0 = zero row;
                            //   null: slot r reads token r
  const float* c_in;        // rows mode: (b * hk, d[1]) f32 channel scales, given
  void* codes[2];           // (b, hk, S, d[t] * bits / 8) int8
  void* scale[2];           // K: (b, hk, 1, d[0]); V: (b, hk, S, 1)
  void* zero[2];
  void* cscale;             // V's c (b, hk, 1, d[1]); store mode only
  const float* eff;         // (b, hk, 2) f32 effective bits per slice and tensor (K, V),
                            //   whole numbers 1..bits; null: the container's (store mode only)
  long long sb[2], sh[2], sl[2];  // source strides in elements: batch, head, token
  int d[2];
  int hk, S;
  int has_k;                // 0: V only (rows mode)
  int rows_per_cta;         // slots per CTA
  int chunk;                // slots staged in shared memory at once
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename P> __device__ __forceinline__ P from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive values from shared memory (p aligned to N * sizeof(T)).
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, float (&x)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < PER; ++j) x[i * PER + j] = to_f32(e[j]);
    }
  } else {
    static_assert(BYTES == 8, "a thread's run is 8 bytes or whole 16-byte words");
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_f32(e[j]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(fill ? 16 : 0) : "memory");
}

// Stage slots [r0, r0 + n) of the slice (row bi, head h) of tensor t: row r
// of `stage` is the source row idx[bi, r0 + r], zeros where that is < 0.
// The slot indices come into shared memory first (`sidx`), in one round
// trip, so that every 16-byte copy can be issued without waiting on one.
template <typename T>
__device__ void stage_rows(T* stage, int* sidx, const StoreDesc& a, int t, int bi, int h, int d,
                           int r0, int n) {
  if (a.idx) {
    for (int r = threadIdx.x; r < n; r += THREADS) sidx[r] = a.idx[(long long)bi * a.S + r0 + r];
    __syncthreads();
  }
  const int shift = __ffs(d * (int)sizeof(T) / 16) - 1;  // log2 of 16-byte pieces per row
  const char* base = static_cast<const char*>(a.src[t]) +
                     (bi * a.sb[t] + h * a.sh[t]) * (long long)sizeof(T);
  for (int p = threadIdx.x; p < (n << shift); p += THREADS) {
    const int r = p >> shift;
    const int tok = a.idx ? sidx[r] : r0 + r;
    const char* g = base + (p - (r << shift)) * 16;
    if (tok >= 0) g += tok * a.sl[t] * (long long)sizeof(T);
    cp_async16(reinterpret_cast<char*>(stage) + (size_t)p * 16, g, tok >= 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// channels per word of codes, and the words a thread of a d-wide row takes
// (M: 1 up to a warp per row, else d / (32 * VPW), so that a warp owns a row)
__host__ __device__ constexpr int word_channels(int bits) { return bits == 8 ? 4 : 8; }
__host__ __device__ constexpr int row_mult(int d, int bits) {
  return d / word_channels(bits) > 32 ? d / (32 * word_channels(bits)) : 1;
}

template <typename T, typename P, int BITS, bool C_GIVEN, bool HAS_EFF, int M>
__device__ __forceinline__ void store_body(const StoreDesc& a, unsigned char* smem) {
  constexpr int VPW = word_channels(BITS);  // channels per word of codes
  constexpr int VPT = VPW * M;              // channels per thread
  using W = typename std::conditional<VPW * BITS == 32, uint32_t, uint16_t>::type;  // a word
  constexpr float QMAX = float((1 << BITS) - 1);

  const int t = a.has_k ? blockIdx.y / a.hk : 1;
  const int h = blockIdx.y % a.hk, bi = blockIdx.z;
  const int d = a.d[t], dmax = max(a.d[0], a.d[1]);
  const int tpr = d / VPT;                  // threads per row, a power of two <= 32
  const int wpr = tpr * M;                  // words of codes per row
  const int rl = threadIdx.x / tpr, g = threadIdx.x % tpr, n_rl = THREADS / tpr;
  const int r_begin = blockIdx.x * a.rows_per_cta;
  const int n_rows = max(min(a.S - r_begin, a.rows_per_cta), 0);
  const long long slice = (long long)bi * a.hk + h;
  // the slice's qmax: the container's, or 2**eff - 1 of its table entry
  const float qm =
      HAS_EFF ? static_cast<float>((1u << static_cast<int>(a.eff[slice * 2 + t])) - 1u) : QMAX;

  // shared: staged rows (chunk x dmax) | their slot indices (chunk) | warp
  // partials 2 x WARPS x dmax | column statistics 2 x dmax | channel
  // parameters 2 x dmax
  T* stage = reinterpret_cast<T*>(smem);
  int* sidx = reinterpret_cast<int*>(smem + (size_t)a.chunk * dmax * sizeof(T));
  float* wpart = reinterpret_cast<float*>(sidx + (a.chunk + 3) / 4 * 4);
  float* col = wpart + 2 * WARPS * dmax;
  float* par = col + 2 * dmax;

  float p0[VPT], p1[VPT];  // K: scale, zero; V: c (p0) of this thread's channels
  if constexpr (C_GIVEN) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) p0[i] = a.c_in[slice * d + g * VPT + i], p1[i] = 0.f;
  } else {
    // pass 1: column statistics over this CTA's slots (V: abs max in hi)
    float lo[VPT], hi[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) lo[i] = INFINITY, hi[i] = t ? 0.f : -INFINITY;
    for (int c0 = 0; c0 < n_rows; c0 += a.chunk) {
      if (c0) __syncthreads();
      const int n = min(a.chunk, n_rows - c0);
      stage_rows(stage, sidx, a, t, bi, h, d, r_begin + c0, n);
      for (int r = rl; r < n; r += n_rl) {
        float x[VPT];
        load_vals<T, VPT>(stage + (size_t)r * d + g * VPT, x);
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          if (t) {
            hi[i] = fmaxf(hi[i], fabsf(x[i]));
          } else {
            lo[i] = fminf(lo[i], x[i]);
            hi[i] = fmaxf(hi[i], x[i]);
          }
        }
      }
    }
    for (int o = tpr; o < 32; o <<= 1) {  // the rows of a warp
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        lo[i] = fminf(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], o));
        hi[i] = fmaxf(hi[i], __shfl_xor_sync(0xffffffffu, hi[i], o));
      }
    }
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 < tpr) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        wpart[warp * dmax + g * VPT + i] = lo[i];
        wpart[(WARPS + warp) * dmax + g * VPT + i] = hi[i];
      }
    }
    __syncthreads();
    const int j = threadIdx.x;  // thread j finishes channel j
    float l = INFINITY, u = t ? 0.f : -INFINITY;
    if (j < d) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        l = fminf(l, wpart[w * dmax + j]);
        u = fmaxf(u, wpart[(WARPS + w) * dmax + j]);
      }
    }
    if (gridDim.x > 1) {  // the slice's CTAs are one cluster: combine their statistics
      cg::cluster_group cluster = cg::this_cluster();
      if (j < d) {
        col[j] = l;
        col[dmax + j] = u;
      }
      cluster.sync();
      if (j < d) {
        const unsigned n_cta = cluster.num_blocks();
        float ol[MAX_CLUSTER], ou[MAX_CLUSTER];  // every rank's loads in flight at once
#pragma unroll
        for (unsigned r = 0; r < MAX_CLUSTER; ++r) {
          if (r < n_cta) {
            const float* other = cluster.map_shared_rank(col, r);
            ol[r] = other[j];
            ou[r] = other[dmax + j];
          }
        }
#pragma unroll
        for (unsigned r = 0; r < MAX_CLUSTER; ++r) {
          if (r < n_cta) {
            l = fminf(l, ol[r]);
            u = fmaxf(u, ou[r]);
          }
        }
      }
      // no CTA may leave while another reads its shared memory: arrive
      // now, wait at the end of the kernel (pass 2 runs in between)
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    }
    if (j < d) {
      if (t) {
        const float c = __fsqrt_rn(fmaxf(u, EPS));
        par[j] = c;
        if (blockIdx.x == 0) static_cast<P*>(a.cscale)[slice * d + j] = from_f32<P>(c);
      } else {
        const float scale = fmaxf(__fdiv_rn(u - l, qm), EPS);
        const float zero = rintf(__fdiv_rn(-l, scale));
        par[j] = scale;
        par[dmax + j] = zero;
        if (blockIdx.x == 0) {
          static_cast<P*>(a.scale[0])[slice * d + j] = from_f32<P>(scale);
          static_cast<P*>(a.zero[0])[slice * d + j] = from_f32<P>(zero);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      p0[i] = par[g * VPT + i];
      p1[i] = par[dmax + g * VPT + i];
    }
  }

  // pass 2: codes, and V's per-slot parameters.  A slot whose index is < 0
  // holds +0 in every channel, whose codes and parameters need no division:
  // K's codes are clip(round(0 + zero)); V's row has min = max = +0, so
  // scale = eps, zero = round(-0 / eps) = -0 and every code 0 (the
  // reference's arithmetic, bit for bit).
  W zero_row[M] = {};
  if (t == 0) {
#pragma unroll
    for (int w = 0; w < M; ++w)
#pragma unroll
      for (int i = 0; i < VPW; ++i)
        zero_row[w] |= static_cast<W>(static_cast<uint32_t>(
                           fminf(fmaxf(rintf(0.f + p1[w * VPW + i]), 0.f), qm)) << (BITS * i));
  }
  W* codes = static_cast<W*>(a.codes[t]) + (slice * a.S + r_begin) * wpr;
  P* vscale = static_cast<P*>(a.scale[1]) + slice * a.S + r_begin;
  P* vzero = static_cast<P*>(a.zero[1]) + slice * a.S + r_begin;
  const bool resident = !C_GIVEN && n_rows <= a.chunk;
  for (int c0 = 0; c0 < n_rows; c0 += a.chunk) {
    const int n = min(a.chunk, n_rows - c0);
    if (!resident) {
      __syncthreads();
      stage_rows(stage, sidx, a, t, bi, h, d, r_begin + c0, n);
    }
    // rows in blocks of n_rl: every lane reaches the shuffles
    for (int rb = 0; rb < n; rb += n_rl) {
      const int r = rb + rl;
      const bool live = r < n;
      // a row past the run, or a zero slot: no division
      const bool zero_slot = !C_GIVEN && a.idx && live && sidx[r] < 0;
      const bool skip = !live || zero_slot;
      float x[VPT];
      if (!skip) {
        load_vals<T, VPT>(stage + (size_t)r * d + g * VPT, x);
      } else {
#pragma unroll
        for (int i = 0; i < VPT; ++i) x[i] = 0.f;
      }
      W word[M] = {};
      if (t == 0) {
        if (skip) {
#pragma unroll
          for (int w = 0; w < M; ++w) word[w] = zero_row[w];
        } else {
#pragma unroll
          for (int i = 0; i < VPT; ++i) {
            const float q = fminf(fmaxf(rintf(__fdiv_rn(x[i], p0[i]) + p1[i]), 0.f), qm);
            word[i / VPW] |= static_cast<W>(static_cast<uint32_t>(q) << (BITS * (i % VPW)));
          }
        }
      } else {
        float mn = INFINITY, mx = -INFINITY;
        if (!skip) {
#pragma unroll
          for (int i = 0; i < VPT; ++i) {
            x[i] = __fdiv_rn(x[i], p0[i]);
            mn = fminf(mn, x[i]);
            mx = fmaxf(mx, x[i]);
          }
        }
        for (int o = tpr >> 1; o; o >>= 1) {
          mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        float scale = EPS, zero = -0.f;
        if (!skip) {
          scale = fmaxf(__fdiv_rn(mx - mn, qm), EPS);
          zero = rintf(__fdiv_rn(-mn, scale));
#pragma unroll
          for (int i = 0; i < VPT; ++i) {
            const float q = fminf(fmaxf(rintf(__fdiv_rn(x[i], scale) + zero), 0.f), qm);
            word[i / VPW] |= static_cast<W>(static_cast<uint32_t>(q) << (BITS * (i % VPW)));
          }
        }
        if (live && g == 0) {
          vscale[c0 + r] = from_f32<P>(scale);
          vzero[c0 + r] = from_f32<P>(zero);
        }
      }
      if (live) {
#pragma unroll
        for (int w = 0; w < M; ++w) codes[(size_t)(c0 + r) * wpr + g * M + w] = word[w];
      }
    }
  }
  if (!C_GIVEN && gridDim.x > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// MMAX: the largest multiplier of the launch's tensors (1, 2 or 4); each
// CTA runs the body of its own tensor's
template <typename T, typename P, int BITS, bool C_GIVEN, bool HAS_EFF, int MMAX>
__global__ void __launch_bounds__(THREADS, MMAX == 1 ? 2 : 1) store_kernel(const StoreDesc a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (MMAX == 1) {
    store_body<T, P, BITS, C_GIVEN, HAS_EFF, 1>(a, smem);
  } else {
    const int m = row_mult(a.d[a.has_k ? blockIdx.y / a.hk : 1], BITS);
    if (m == MMAX) {
      store_body<T, P, BITS, C_GIVEN, HAS_EFF, MMAX>(a, smem);
    } else if constexpr (MMAX == 4) {
      if (m == 2)
        store_body<T, P, BITS, C_GIVEN, HAS_EFF, 2>(a, smem);
      else
        store_body<T, P, BITS, C_GIVEN, HAS_EFF, 1>(a, smem);
    } else {
      store_body<T, P, BITS, C_GIVEN, HAS_EFF, 1>(a, smem);
    }
  }
}

size_t smem_bytes(const StoreDesc& a, size_t elem) {
  const size_t dmax = a.d[0] > a.d[1] ? a.d[0] : a.d[1];
  return (size_t)a.chunk * dmax * elem + (a.chunk + 3) / 4 * 16 +
         (2 * WARPS + 4) * dmax * sizeof(float);
}

template <typename T, typename P, int BITS, bool C_GIVEN, bool HAS_EFF, int MMAX>
cudaError_t launch(const StoreDesc& a, int b, int split, cudaStream_t stream) {
  auto kernel = store_kernel<T, P, BITS, C_GIVEN, HAS_EFF, MMAX>;
  const size_t smem = smem_bytes(a, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (a.has_k ? 2 : 1) * a.hk, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (!C_GIVEN && split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T, typename P, int BITS, bool C_GIVEN, bool HAS_EFF>
cudaError_t launch_m(const StoreDesc& a, int b, int split, cudaStream_t stream) {
  int mmax = row_mult(a.d[1], BITS);
  if (a.has_k && row_mult(a.d[0], BITS) > mmax) mmax = row_mult(a.d[0], BITS);
  if (mmax == 1) return launch<T, P, BITS, C_GIVEN, HAS_EFF, 1>(a, b, split, stream);
  if (mmax == 2) return launch<T, P, BITS, C_GIVEN, HAS_EFF, 2>(a, b, split, stream);
  if constexpr (BITS == 8)  // 4 words a thread: 8-bit rows wider than 256 channels
    return launch<T, P, BITS, C_GIVEN, HAS_EFF, 4>(a, b, split, stream);
  return cudaErrorInvalidValue;
}

template <typename T, bool C_GIVEN, bool HAS_EFF>
cudaError_t dispatch(const StoreDesc& a, int b, int split, int bits, cudaStream_t stream) {
  using P = typename std::conditional<C_GIVEN, float, T>::type;
  switch (bits) {
    case 2: return launch_m<T, P, 2, C_GIVEN, HAS_EFF>(a, b, split, stream);
    case 4: return launch_m<T, P, 4, C_GIVEN, HAS_EFF>(a, b, split, stream);
    default: return launch_m<T, P, 8, C_GIVEN, HAS_EFF>(a, b, split, stream);
  }
}

// a row of d channels: whole words, a power of two of them, at most one
// channel a thread (d <= THREADS: pass 1 finishes channel j on thread j),
// whole 16-byte pieces
bool head_dim_ok(int d, int bits, int elem) {
  const int vpw = word_channels(bits), words = d / vpw;
  return d > 0 && d % vpw == 0 && (words & (words - 1)) == 0 && (d * elem) % 16 == 0 &&
         d <= THREADS;
}

}  // namespace

extern "C" const char* zc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One store (rows_mode 0: K and V, c computed, store-dtype parameters, qmax
// from the desc's eff table where it has one) or one cst_quant_rows call
// (rows_mode 1: V only, c given, f32 parameters, no gather, no table), over b
// batch rows with `split` CTAs per (row, head, tensor).
// `desc` points at a StoreDesc (a plain C pointer: the struct itself has
// internal linkage).
extern "C" int cst_store_launch(const void* desc, int b, int split, int bits, int t_bf16,
                                int rows_mode, void* stream) {
  const StoreDesc* a = static_cast<const StoreDesc*>(desc);
  const int elem = t_bf16 ? 2 : 4;
  const bool ok = (bits == 2 || bits == 4 || bits == 8) && b > 0 && a->hk > 0 && a->S > 0 &&
                  split > 0 && a->rows_per_cta > 0 && a->chunk > 0 &&
                  (long long)split * a->rows_per_cta >= a->S &&
                  head_dim_ok(a->d[1], bits, elem) &&
                  (rows_mode ? !a->has_k && a->c_in && !a->eff
                             : a->has_k && split <= MAX_CLUSTER &&
                                   head_dim_ok(a->d[0], bits, elem));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows_mode)
    err = t_bf16 ? dispatch<__nv_bfloat16, true, false>(*a, b, split, bits, s)
                 : dispatch<float, true, false>(*a, b, split, bits, s);
  else if (a->eff)
    err = t_bf16 ? dispatch<__nv_bfloat16, false, true>(*a, b, split, bits, s)
                 : dispatch<float, false, true>(*a, b, split, bits, s);
  else
    err = t_bf16 ? dispatch<__nv_bfloat16, false, false>(*a, b, split, bits, s)
                 : dispatch<float, false, false>(*a, b, split, bits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
