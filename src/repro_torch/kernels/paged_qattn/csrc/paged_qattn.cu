// One-token GQA decode attention over one PAGED ZipCache store segment, sm_90a.
//
// Replaces src/repro/kernels/paged_qattn/kernel.py::qattn_paged_segment
// (body _paged_qattn_kernel).  The payload lives in page pools
// (P, hk, page, c) addressed through a (b, npp) page table; the small
// per-slot parameters stay dense.  The TPU kernel took the table as a
// scalar-prefetch operand and let each grid step's index map pick the page;
// here each CTA loads table[b, slot / page] itself and forms the token row
// ((pid * hk + h) * page + slot % page) of the pool.  NULL entries of the
// free-list layout point at the sink page; their slots carry pos < 0 and
// are masked.
//
// Dequant (quantized segments): K is channelwise, k = (code - zero_c) *
// scale_c; V is CST, v = ((code - zero_t) * scale_t) * c_chan.  Codes are
// packed LSB-first, 8 / bits to a byte.  Both round to the store dtype T
// before use, as QuantizedTensor.dequantize does on the reference's live
// path (the TPU kernel's k_dtype / v_dtype).  Raw segments (the bf16
// staging window, fp16 stores) are a separate instantiation on the page
// dtype T: values pass through.  Slots with pos < 0 are masked; a row with
// no valid slot gives l = 0 and acc = 0.
//
// Outputs, per query head: flash-decoding stats (acc, m, l), and when asked
// the per-slot p = exp(s - m_run) with the running max m_run it is relative
// to, so the caller rebuilds the softmax row as p * exp(m_run - m).
//
// Bound on the H100: bytes.  A decode step reads every referenced page once
// and does ~2 multiply-adds per dequantized element.  A segment has only
// b * hk (slot, kv head) pairs (16 at yi-6b width with 4 slots), so the
// logical slot axis is split over CTAs as well (split-S, about two CTAs per
// SM).  Each CTA of 128 threads takes one (kv head, slot) pair and a run of
// 32-slot blocks: a block's K and V are unpacked and dequantized into shared
// memory once and shared by the g = h / hk query rows (8 at yi-6b width);
// scores and the online softmax are f32 on the CUDA cores.  Each CTA writes
// partial (acc, m, l); a second small kernel merges the splits in split
// order, one CTA per (slot, head): deterministic, no float atomics.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int BS = 32;  // slots per block == warp width (one lane per slot)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round to the store dtype and lift back to f32
template <typename T> __device__ __forceinline__ float store_round(float v) {
  return to_f32(from_f32<T>(v));
}

// field j of a packed row; bits in {2, 4, 8}, pack factor 8 / bits
__device__ __forceinline__ float unpack_code(const int8_t* row, int j, int bits) {
  const int shift = bits == 2 ? 2 : (bits == 4 ? 1 : 0);  // log2(8 / bits)
  const unsigned byte = static_cast<uint8_t>(row[j >> shift]);
  return static_cast<float>((byte >> ((j & ((1 << shift) - 1)) * bits)) & ((1u << bits) - 1u));
}

// Q: query dtype.  T: parameter (and rounding) dtype of a quantized segment,
// page dtype of a raw one.
template <typename Q, typename T, int D, bool RAW>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const Q* __restrict__ q, const void* __restrict__ kpool,
                   const T* __restrict__ ks, const T* __restrict__ kz,
                   const void* __restrict__ vpool, const T* __restrict__ vcs,
                   const T* __restrict__ vts, const T* __restrict__ vtz,
                   const int* __restrict__ pos, const int* __restrict__ table,
                   float* __restrict__ acc_part, float* __restrict__ m_part,
                   float* __restrict__ l_part, float* __restrict__ p_out,
                   float* __restrict__ mrun_out, int h, int hk, int page, int npp, int k_bits,
                   int v_bits, float scale, int blocks_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = h / hk;
  long long* rows = reinterpret_cast<long long*>(smem_raw);  // [BS] pool token rows, -1 = none
  int* vflag = reinterpret_cast<int*>(rows + BS);            // [BS]
  float* qs = reinterpret_cast<float*>(vflag + BS);          // [g][D], pre-scaled
  float* kb = qs + g * D;                                    // [BS][D + 1]
  float* vb = kb + BS * (D + 1);                             // [BS][D]
  float* ps = vb + BS * D;                                   // [g][BS]
  float* acc = ps + g * BS;                                  // [g][D]
  float* ms = acc + g * D;                                   // [g]
  float* ls = ms + g;                                        // [g]
  float* al = ls + g;                                        // [g]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const int S = npp * page;
  const size_t bh = (size_t)b * hk + kvh;
  const int kpd = RAW ? D : D / (8 / k_bits), vpd = RAW ? D : D / (8 / v_bits);

  for (int e = tid; e < g * D; e += THREADS)
    qs[e] = to_f32(q[((size_t)b * h + kvh * g) * D + e]) * scale;
  for (int e = tid; e < g * D; e += THREADS) acc[e] = 0.f;
  for (int r = tid; r < g; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.f;
  }

  const int s_begin = split * blocks_per_split * BS;
  const int s_end = min(S, s_begin + blocks_per_split * BS);
  for (int s0 = s_begin; s0 < s_end; s0 += BS) {
    __syncthreads();
    if (tid < BS) {
      const int slot = s0 + tid;
      long long row = -1;
      int valid = 0;
      if (slot < s_end) {
        const int pid = table[(size_t)b * npp + slot / page];
        row = ((long long)pid * hk + kvh) * page + slot % page;
        valid = pos[(size_t)b * S + slot] >= 0;
      }
      rows[tid] = row;
      vflag[tid] = valid;
    }
    __syncthreads();
    for (int e = tid; e < BS * D; e += THREADS) {
      const int s = e / D, j = e % D;
      const long long row = rows[s];
      float kval = 0.f, vval = 0.f;
      if (row >= 0) {
        if constexpr (RAW) {
          kval = to_f32(static_cast<const T*>(kpool)[row * D + j]);
          vval = to_f32(static_cast<const T*>(vpool)[row * D + j]);
        } else {
          const int slot = s0 + s;
          const float kcode = unpack_code(static_cast<const int8_t*>(kpool) + row * kpd, j, k_bits);
          kval = store_round<T>((kcode - to_f32(kz[bh * D + j])) * to_f32(ks[bh * D + j]));
          const float vcode = unpack_code(static_cast<const int8_t*>(vpool) + row * vpd, j, v_bits);
          vval = (vcode - to_f32(vtz[bh * S + slot])) * to_f32(vts[bh * S + slot]);
          vval = store_round<T>(vval * to_f32(vcs[bh * D + j]));
        }
      }
      kb[s * (D + 1) + j] = kval;
      vb[s * D + j] = vval;
    }
    __syncthreads();

    for (int e = tid; e < g * BS; e += THREADS) {
      const int r = e / BS, s = e % BS;
      float acc_s = 0.f;
#pragma unroll 8
      for (int j = 0; j < D; ++j) acc_s += qs[r * D + j] * kb[s * (D + 1) + j];
      ps[r * BS + s] = acc_s;
    }
    __syncthreads();

    for (int r = warp; r < g; r += THREADS / 32) {
      const bool valid = vflag[lane];
      const float sc = valid ? ps[r * BS + lane] : NEG_INF;
      float mx = sc;
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = valid ? expf(sc - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * BS + lane] = p;
      if (p_out != nullptr && s0 + lane < s_end) {
        const size_t o = ((size_t)b * h + kvh * g + r) * S + s0 + lane;
        p_out[o] = p;
        mrun_out[o] = m_new;
      }
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al[r] = alpha;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < g * D; e += THREADS) {
      const int r = e / D, c = e % D;
      float a = acc[e] * al[r];
#pragma unroll 8
      for (int s = 0; s < BS; ++s) a += ps[r * BS + s] * vb[s * D + c];
      acc[e] = a;
    }
  }
  __syncthreads();

  // partials laid out (b, h, nsplit, ...): head kvh * g + r of slot b
  for (int e = tid; e < g * D; e += THREADS) {
    const int r = e / D, c = e % D;
    acc_part[(((size_t)b * h + kvh * g + r) * nsplit + split) * D + c] = acc[e];
  }
  for (int r = tid; r < g; r += THREADS) {
    m_part[((size_t)b * h + kvh * g + r) * nsplit + split] = ms[r];
    l_part[((size_t)b * h + kvh * g + r) * nsplit + split] = ls[r];
  }
}

// One CTA of D threads per (slot, head): merge the splits' (acc, m, l) in order.
template <int D>
__global__ void __launch_bounds__(D)
paged_merge_kernel(const float* __restrict__ acc_part, const float* __restrict__ m_part,
                   const float* __restrict__ l_part, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int nsplit) {
  const size_t bh = blockIdx.x;
  const int c = threadIdx.x;
  const float* mp = m_part + bh * nsplit;
  const float* lp = l_part + bh * nsplit;
  float m_all = NEG_INF;
  for (int i = 0; i < nsplit; ++i) m_all = fmaxf(m_all, mp[i]);
  float a = 0.f, l = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float w = expf(mp[i] - m_all);
    a += acc_part[(bh * nsplit + i) * D + c] * w;
    l += lp[i] * w;
  }
  acc_out[bh * D + c] = a;
  if (c == 0) {
    m_out[bh] = m_all;
    l_out[bh] = l;
  }
}

struct Args {
  const void *q, *kpool, *ks, *kz, *vpool, *vcs, *vts, *vtz, *pos, *table;
  void *acc_part, *m_part, *l_part, *acc, *m, *l, *p, *mrun;
  int b, h, hk, page, npp, k_bits, v_bits;
  float scale;
  int blocks_per_split, nsplit;
  cudaStream_t stream;
};

template <typename Q, typename T, int D, bool RAW>
cudaError_t launch(const Args& a) {
  const int g = a.h / a.hk;
  const size_t smem = sizeof(long long) * BS + sizeof(int) * BS +
                      sizeof(float) * (g * D + BS * (D + 1) + BS * D + g * BS + g * D + 3 * g);
  auto kernel = paged_split_kernel<Q, T, D, RAW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.hk, a.b, a.nsplit);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const Q*>(a.q), a.kpool, static_cast<const T*>(a.ks),
      static_cast<const T*>(a.kz), a.vpool, static_cast<const T*>(a.vcs),
      static_cast<const T*>(a.vts), static_cast<const T*>(a.vtz),
      static_cast<const int*>(a.pos), static_cast<const int*>(a.table),
      static_cast<float*>(a.acc_part), static_cast<float*>(a.m_part),
      static_cast<float*>(a.l_part), static_cast<float*>(a.p), static_cast<float*>(a.mrun),
      a.h, a.hk, a.page, a.npp, a.k_bits, a.v_bits, a.scale, a.blocks_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<D><<<a.b * a.h, D, 0, a.stream>>>(
      static_cast<const float*>(a.acc_part), static_cast<const float*>(a.m_part),
      static_cast<const float*>(a.l_part), static_cast<float*>(a.acc), static_cast<float*>(a.m),
      static_cast<float*>(a.l), a.nsplit);
  return cudaGetLastError();
}

template <typename Q, typename T, bool RAW>
cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch<Q, T, 16, RAW>(a);
    case 32: return launch<Q, T, 32, RAW>(a);
    case 64: return launch<Q, T, 64, RAW>(a);
    case 128: return launch<Q, T, 128, RAW>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Q, typename T>
cudaError_t launch_raw(int d, int raw, const Args& a) {
  return raw ? launch_d<Q, T, true>(d, a) : launch_d<Q, T, false>(d, a);
}

}  // namespace

extern "C" const char* zc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (b,h,d) | K / V pools (P,hk,page,c): int8 codes (c = d * bits / 8) or raw
// values (c = d) | k scale/zero (b,hk,1,d) | v chan scale (b,hk,1,d) | v token
// scale/zero (b,hk,S_pad,1) | pos (b,S_pad) int32 | table (b,npp) int32, with
// S_pad = npp * page.  q in bf16 or f32 (q_bf16); T, the parameters' dtype of
// a quantized segment or the pages' dtype of a raw one, in bf16 or f32
// (t_bf16).  Raw segments pass null parameters.  Scratch acc_part
// (b,h,nsplit,d), m_part / l_part (b,h,nsplit) f32, nsplit * blocks_per_split
// * 32 >= S_pad.  Outputs acc (b,h,d), m (b,h), l (b,h) f32; p and mrun
// (b,h,S_pad) f32, or both null to skip them.
extern "C" int paged_qattn_launch(const void* q, const void* kpool, const void* ks,
                                  const void* kz, const void* vpool, const void* vcs,
                                  const void* vts, const void* vtz, const void* pos,
                                  const void* table, void* acc_part, void* m_part, void* l_part,
                                  void* acc, void* m, void* l, void* p, void* mrun, int b, int h,
                                  int hk, int page, int npp, int d, int k_bits, int v_bits,
                                  float scale, int blocks_per_split, int nsplit, int q_bf16,
                                  int t_bf16, int raw, void* stream) {
  auto bits_ok = [](int bits) { return bits == 2 || bits == 4 || bits == 8; };
  if (b <= 0 || hk <= 0 || h % hk || page <= 0 || npp <= 0 || blocks_per_split <= 0 ||
      nsplit <= 0 || (long long)nsplit * blocks_per_split * BS < (long long)npp * page ||
      (!raw && (!bits_ok(k_bits) || !bits_ok(v_bits))) || ((p == nullptr) != (mrun == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,      kpool,  ks,     kz,     vpool,  vcs,    vts,  vtz,
               pos,    table,  acc_part, m_part, l_part, acc, m,    l,
               p,      mrun,   b,      h,      hk,     page,   npp,  k_bits,
               v_bits, scale,  blocks_per_split, nsplit, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (q_bf16)
    err = t_bf16 ? launch_raw<__nv_bfloat16, __nv_bfloat16>(d, raw, a)
                 : launch_raw<__nv_bfloat16, float>(d, raw, a);
  else
    err = t_bf16 ? launch_raw<float, __nv_bfloat16>(d, raw, a) : launch_raw<float, float>(d, raw, a);
  return static_cast<int>(err);
}
