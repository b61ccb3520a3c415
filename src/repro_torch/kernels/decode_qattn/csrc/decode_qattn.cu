// One-token GQA decode attention over one packed ZipCache store, sm_90a.
//
// Replaces src/repro/kernels/decode_qattn/kernel.py::qattn_segment (body
// _qattn_kernel).  K is channelwise-quantized: k = (code - zero_c) * scale_c;
// V is CST-quantized: v = ((code - zero_t) * scale_t) * c_chan.  Both are
// rounded to the store dtype P before use, as QuantizedTensor.dequantize
// does on the reference's live path (the paged_qattn kernel's k_dtype /
// v_dtype).  Slots with pos < 0 are masked.  Emits flash-decoding stats
// (acc, m, l) per query head so the caller merges the hi / lo / window
// segments exactly.
//
// Bound on the H100: bytes.  One decode step reads every packed code once
// (d/2 or d/4 bytes per token and head) and does ~2 multiply-adds per
// dequantized element.  A store has only b * hk (batch, kv head) pairs (16
// at yi-6b width, batch 4), so one CTA per pair left most of the 132 SMs
// idle.  Design: a split-S grid.  Each CTA of 128 threads takes one
// (kv head, batch) pair and a run of 32-slot blocks: a block's K and V are
// unpacked and dequantized into shared memory once and shared by the
// g = h/hk query rows of the group (8 at yi-6b width); scores and the
// online softmax are f32 on the CUDA cores.  Each CTA writes partial
// (acc, m, l); a second small kernel merges the splits, one CTA per
// (batch, head), in split order (deterministic, no atomics).
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
template <typename P> __device__ __forceinline__ float store_round(float v) {
  return to_f32(from_f32<P>(v));
}

// field j of a packed row; bits in {2, 4}, so pack factor 8 / bits is 4 or 2
__device__ __forceinline__ float unpack_code(const int8_t* row, int j, int bits) {
  const int shift = bits == 2 ? 2 : 1;  // log2(8 / bits)
  const unsigned byte = static_cast<uint8_t>(row[j >> shift]);
  return static_cast<float>((byte >> ((j & ((1 << shift) - 1)) * bits)) & ((1u << bits) - 1u));
}

template <typename P, int D>
__global__ void __launch_bounds__(THREADS)
qattn_split_kernel(const P* __restrict__ q, const int8_t* __restrict__ kc,
                   const P* __restrict__ ks, const P* __restrict__ kz,
                   const int8_t* __restrict__ vc, const P* __restrict__ vcs,
                   const P* __restrict__ vts, const P* __restrict__ vtz,
                   const int* __restrict__ pos, float* __restrict__ acc_part,
                   float* __restrict__ m_part, float* __restrict__ l_part, int h, int hk, int S,
                   int k_bits, int v_bits, float scale, int blocks_per_split) {
  extern __shared__ float smem[];
  const int g = h / hk;
  float* qs = smem;                 // [g][D], pre-scaled
  float* kb = qs + g * D;           // [BS][D + 1]
  float* vb = kb + BS * (D + 1);    // [BS][D]
  float* ps = vb + BS * D;          // [g][BS]
  float* acc = ps + g * BS;         // [g][D]
  float* ms = acc + g * D;          // [g]
  float* ls = ms + g;               // [g]
  float* al = ls + g;               // [g]
  int* vflag = reinterpret_cast<int*>(al + g);  // [BS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const size_t bh = (size_t)b * hk + kvh;
  const int kpd = D / (8 / k_bits), vpd = D / (8 / v_bits);
  const int8_t* kcs = kc + bh * S * kpd;
  const int8_t* vcs_codes = vc + bh * S * vpd;
  const P* ksc = ks + bh * D;
  const P* kze = kz + bh * D;
  const P* vch = vcs + bh * D;
  const P* vts_s = vts + bh * S;
  const P* vtz_s = vtz + bh * S;
  const int* pos_b = pos + (size_t)b * S;

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
    for (int e = tid; e < BS * D; e += THREADS) {
      const int s = e / D, j = e % D, slot = s0 + s;
      float kval = 0.f, vval = 0.f;
      if (slot < s_end) {
        const float kcode = unpack_code(kcs + (size_t)slot * kpd, j, k_bits);
        kval = store_round<P>((kcode - to_f32(kze[j])) * to_f32(ksc[j]));
        const float vcode = unpack_code(vcs_codes + (size_t)slot * vpd, j, v_bits);
        vval = (vcode - to_f32(vtz_s[slot])) * to_f32(vts_s[slot]);
        vval = store_round<P>(vval * to_f32(vch[j]));
      }
      kb[s * (D + 1) + j] = kval;
      vb[s * D + j] = vval;
    }
    if (tid < BS) vflag[tid] = (s0 + tid < s_end) && pos_b[s0 + tid] >= 0;
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

  // partials laid out (b, h, nsplit, ...): head kvh * g + r of batch b
  for (int e = tid; e < g * D; e += THREADS) {
    const int r = e / D, c = e % D;
    acc_part[(((size_t)b * h + kvh * g + r) * nsplit + split) * D + c] = acc[e];
  }
  for (int r = tid; r < g; r += THREADS) {
    m_part[((size_t)b * h + kvh * g + r) * nsplit + split] = ms[r];
    l_part[((size_t)b * h + kvh * g + r) * nsplit + split] = ls[r];
  }
}

// One CTA of D threads per (batch, head): merge the splits' (acc, m, l).
template <int D>
__global__ void __launch_bounds__(D)
qattn_merge_kernel(const float* __restrict__ acc_part, const float* __restrict__ m_part,
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

template <typename P, int D>
cudaError_t launch(const void* q, const void* kc, const void* ks, const void* kz, const void* vc,
                   const void* vcs, const void* vts, const void* vtz, const void* pos,
                   void* acc_part, void* m_part, void* l_part, void* acc, void* m, void* l,
                   int b, int h, int hk, int S, int k_bits, int v_bits, float scale,
                   int blocks_per_split, int nsplit, cudaStream_t stream) {
  const int g = h / hk;
  const size_t smem = sizeof(float) * (g * D + BS * (D + 1) + BS * D + g * BS + g * D + 3 * g) +
                      sizeof(int) * BS;
  cudaError_t err = cudaFuncSetAttribute(qattn_split_kernel<P, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(hk, b, nsplit);
  qattn_split_kernel<P, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const P*>(q), static_cast<const int8_t*>(kc), static_cast<const P*>(ks),
      static_cast<const P*>(kz), static_cast<const int8_t*>(vc), static_cast<const P*>(vcs),
      static_cast<const P*>(vts), static_cast<const P*>(vtz), static_cast<const int*>(pos),
      static_cast<float*>(acc_part), static_cast<float*>(m_part), static_cast<float*>(l_part),
      h, hk, S, k_bits, v_bits, scale, blocks_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qattn_merge_kernel<D><<<b * h, D, 0, stream>>>(
      static_cast<const float*>(acc_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), nsplit);
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_d(int d, const void* q, const void* kc, const void* ks, const void* kz,
                     const void* vc, const void* vcs, const void* vts, const void* vtz,
                     const void* pos, void* ap, void* mp, void* lp, void* acc, void* m, void* l,
                     int b, int h, int hk, int S, int kb, int vb, float scale, int bps, int ns,
                     cudaStream_t s) {
  switch (d) {
    case 16: return launch<P, 16>(q, kc, ks, kz, vc, vcs, vts, vtz, pos, ap, mp, lp, acc, m, l, b, h, hk, S, kb, vb, scale, bps, ns, s);
    case 32: return launch<P, 32>(q, kc, ks, kz, vc, vcs, vts, vtz, pos, ap, mp, lp, acc, m, l, b, h, hk, S, kb, vb, scale, bps, ns, s);
    case 64: return launch<P, 64>(q, kc, ks, kz, vc, vcs, vts, vtz, pos, ap, mp, lp, acc, m, l, b, h, hk, S, kb, vb, scale, bps, ns, s);
    case 128: return launch<P, 128>(q, kc, ks, kz, vc, vcs, vts, vtz, pos, ap, mp, lp, acc, m, l, b, h, hk, S, kb, vb, scale, bps, ns, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* zc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (b,h,d) | k codes (b,hk,S,d/pf_k) int8 | k scale/zero (b,hk,1,d)
// v codes (b,hk,S,d/pf_v) int8 | v chan scale (b,hk,1,d) | v token scale/zero (b,hk,S,1)
// pos (b,S) int32.  q and every parameter in the store dtype P (bf16 or f32);
// d in {16, 32, 64, 128} for K and V alike.  Scratch acc_part (b,h,nsplit,d),
// m_part / l_part (b,h,nsplit) f32, nsplit * blocks_per_split * 32 >= S.
// Outputs acc (b,h,d), m (b,h), l (b,h) f32.
extern "C" int decode_qattn_launch(const void* q, const void* kc, const void* ks, const void* kz,
                                   const void* vc, const void* vcs, const void* vts,
                                   const void* vtz, const void* pos, void* acc_part,
                                   void* m_part, void* l_part, void* acc, void* m, void* l, int b,
                                   int h, int hk, int S, int d, int k_bits, int v_bits,
                                   float scale, int blocks_per_split, int nsplit, int is_bf16,
                                   void* stream) {
  if (hk <= 0 || h % hk || S <= 0 || (k_bits != 2 && k_bits != 4) ||
      (v_bits != 2 && v_bits != 4) || blocks_per_split <= 0 || nsplit <= 0 ||
      (long long)nsplit * blocks_per_split * BS < S)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? launch_d<__nv_bfloat16>(d, q, kc, ks, kz, vc, vcs, vts, vtz, pos, acc_part, m_part,
                                l_part, acc, m, l, b, h, hk, S, k_bits, v_bits, scale,
                                blocks_per_split, nsplit, s)
      : launch_d<float>(d, q, kc, ks, kz, vc, vcs, vts, vtz, pos, acc_part, m_part, l_part, acc,
                        m, l, b, h, hk, S, k_bits, v_bits, scale, blocks_per_split, nsplit, s);
  return static_cast<int>(err);
}
