// Prefill attention with the ZipCache probe side-output, for Hopper sm_90a.
//
// flash_fwd replaces src/repro/kernels/probe_flash/kernel.py::flash_fwd
// (body _flash_kernel): FlashAttention-2 causal forward with an f32 LSE.
// probe_colsum replaces ::probe_colsum (body _probe_colsum_kernel): for the
// probe rows, sum_rows exp(q.k * d^-1/2 - lse) per key column, causal and
// pad-row masked, averaged over heads (paper Eq. 9 numerator).
//
// Bound on the H100: operations.  At yi-6b prefill widths (d = 128,
// 1024 tokens) attention does ~128 multiply-adds per byte it reads.  This
// first version computes in f32 on the CUDA cores (no tensor cores, no TMA):
// the reference's arithmetic is f32 on bf16 inputs, and exactness of the
// softmax statistics comes first here.
//
// flash_fwd design: one CTA of 128 threads per (q block of 64 rows, head,
// batch).  The TPU kernel carried acc/m/l across sequential grid steps in
// VMEM; here the kv axis is a loop inside the CTA, with acc in registers
// (each thread owns 4 rows x D/8 columns) and m/l per row reduced across the
// 8 threads that share a row.  Q is staged once, scaled; each 32-column K
// (transposed) and V tile goes through shared memory.  GQA reads
// k[:, h / g]; K/V are never repeated in memory.  Blocks wholly above the
// causal diagonal are skipped.
//
// probe_colsum design: one CTA per (32-column kv block, batch, kv head)
// stages its K tile once and loops over the g query heads of the group and
// the 32-row probe blocks inside (per head and probe block: column sum,
// / heads, accumulate), writing one partial column sum per kv head.  A
// second small kernel adds the kv heads' partials in order.  Every value
// has one writer and there are no float atomics, so the sums, and the
// saliency ties they decide, are deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// flash_fwd
// ---------------------------------------------------------------------------
constexpr int FA_BQ = 64;
constexpr int FA_BK = 32;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (FA_BQ * (D + 1) + D * (FA_BK + 1) + FA_BK * D + FA_BQ * (FA_BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int h, int hk, int lq, int lkv,
                 int diag, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [FA_BQ][D + 1], pre-scaled
  float* Kt = Qs + FA_BQ * (D + 1);          // [D][FA_BK + 1], transposed
  float* Vs = Kt + D * (FA_BK + 1);          // [FA_BK][D]
  float* Ps = Vs + FA_BK * D;                // [FA_BQ][FA_BK + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;   // rows ty*4 .. ty*4+3
  const int tx = tid & 7;    // columns tx + 8*j
  const int q0 = blockIdx.x * FA_BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const T* qh = q + ((size_t)b * h + head) * lq * D;
  const T* kh = k + ((size_t)b * hk + kvh) * lkv * D;
  const T* vh = v + ((size_t)b * hk + kvh) * lkv * D;

  for (int e = tid; e < FA_BQ * D; e += THREADS) {
    const int r = e / D, j = e % D;
    Qs[r * (D + 1) + j] = (q0 + r < lq) ? to_f32(qh[(size_t)(q0 + r) * D + j]) * scale : 0.f;
  }

  constexpr int NC = D / 8;
  float acc[4][NC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(lkv, q0 + FA_BQ + diag) : lkv;
  for (int k0 = 0; k0 < kv_end; k0 += FA_BK) {
    __syncthreads();
    for (int e = tid; e < FA_BK * D; e += THREADS) {
      const int s = e / D, j = e % D;
      const bool in = k0 + s < lkv;
      Kt[j * (FA_BK + 1) + s] = in ? to_f32(kh[(size_t)(k0 + s) * D + j]) : 0.f;
      Vs[s * D + j] = in ? to_f32(vh[(size_t)(k0 + s) * D + j]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < D; ++j) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Kt[j * (FA_BK + 1) + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] += qv[i] * kv[c];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 8 * c;
        valid[c] = col < lkv && (!causal || row + diag >= col);
        sc[i][c] = valid[c] ? sc[i][c] : NEG_INF;
        mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = valid[c] ? expf(sc[i][c] - m_new) : 0.f;
        rs += p;
        Ps[(ty * 4 + i) * (FA_BK + 1) + tx + 8 * c] = p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int s = 0; s < FA_BK; ++s) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (FA_BK + 1) + s];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[s * D + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= lq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = out + (((size_t)b * h + head) * lq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 8 * c] = from_f32<T>(acc[i][c] / l);
    if (tx == 0) lse[((size_t)b * h + head) * lq + row] = m_i[i] + logf(l);
  }
}

template <typename T, int D>
cudaError_t flash_launch_t(const void* q, const void* k, const void* v, void* out, void* lse,
                           int b, int h, int hk, int lq, int lkv, int causal, float scale,
                           cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + FA_BQ - 1) / FA_BQ, h, b);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), h, hk, lq, lkv,
      causal ? lkv - lq : 0, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t flash_launch_d(int d, const void* q, const void* k, const void* v, void* out,
                           void* lse, int b, int h, int hk, int lq, int lkv, int causal,
                           float scale, cudaStream_t s) {
  switch (d) {
    case 16: return flash_launch_t<T, 16>(q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s);
    case 32: return flash_launch_t<T, 32>(q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s);
    case 64: return flash_launch_t<T, 64>(q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s);
    case 128: return flash_launch_t<T, 128>(q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// probe_colsum
// ---------------------------------------------------------------------------
constexpr int PC_BK = 32;
constexpr int PC_BP = 32;

template <int D>
constexpr size_t colsum_smem_bytes() {
  return sizeof(float) * (D * (PC_BK + 1) + PC_BP * (D + 1) + PC_BP * (PC_BK + 1) + PC_BP) +
         sizeof(int) * PC_BP;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
probe_colsum_kernel(const T* __restrict__ qp, const float* __restrict__ lse_p,
                    const int* __restrict__ pos, const T* __restrict__ k,
                    float* __restrict__ partial, int h, int hk, int np, int lkv, int diag,
                    int causal, float scale) {
  extern __shared__ float smem[];
  float* Kt = smem;                          // [D][PC_BK + 1]
  float* Qs = Kt + D * (PC_BK + 1);          // [PC_BP][D + 1], pre-scaled
  float* Ps = Qs + PC_BP * (D + 1);          // [PC_BP][PC_BK + 1]
  float* Ls = Ps + PC_BP * (PC_BK + 1);      // [PC_BP]
  int* Pos = reinterpret_cast<int*>(Ls + PC_BP);

  const int tid = threadIdx.x;
  const int ty = tid >> 3;   // probe rows ty*2, ty*2+1
  const int tx = tid & 7;    // columns tx + 8*c
  const int k0 = blockIdx.x * PC_BK;
  const int b = blockIdx.y;
  const int kvh = blockIdx.z;
  const int g = h / hk;
  float col_acc = 0.f;       // thread tid < PC_BK owns column k0 + tid

  const T* kh = k + ((size_t)b * hk + kvh) * lkv * D;
  for (int e = tid; e < PC_BK * D; e += THREADS) {
    const int s = e / D, j = e % D;
    Kt[j * (PC_BK + 1) + s] = (k0 + s < lkv) ? to_f32(kh[(size_t)(k0 + s) * D + j]) : 0.f;
  }
  for (int head = kvh * g; head < (kvh + 1) * g; ++head) {
    const T* qh = qp + ((size_t)b * h + head) * np * D;
    const float* lh = lse_p + ((size_t)b * h + head) * np;
    for (int p0 = 0; p0 < np; p0 += PC_BP) {
      __syncthreads();
      for (int e = tid; e < PC_BP * D; e += THREADS) {
        const int r = e / D, j = e % D;
        Qs[r * (D + 1) + j] = (p0 + r < np) ? to_f32(qh[(size_t)(p0 + r) * D + j]) * scale : 0.f;
      }
      if (tid < PC_BP) {
        const bool in = p0 + tid < np;
        Ls[tid] = in ? lh[p0 + tid] : 0.f;
        Pos[tid] = in ? pos[(size_t)b * np + p0 + tid] : -1;
      }
      __syncthreads();

      float sc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < D; ++j) {
        float qv[2], kv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) qv[i] = Qs[(ty * 2 + i) * (D + 1) + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = Kt[j * (PC_BK + 1) + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] += qv[i] * kv[c];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty * 2 + i;
        const int pr = Pos[r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = k0 + tx + 8 * c;
          const bool valid = pr >= 0 && col < lkv && (!causal || pr + diag >= col);
          Ps[r * (PC_BK + 1) + tx + 8 * c] = valid ? expf(sc[i][c] - Ls[r]) : 0.f;
        }
      }
      __syncthreads();
      if (tid < PC_BK) {
        float s = 0.f;
        for (int r = 0; r < PC_BP; ++r) s += Ps[r * (PC_BK + 1) + tid];
        col_acc += s / static_cast<float>(h);
      }
    }
  }
  if (tid < PC_BK && k0 + tid < lkv)
    partial[((size_t)b * hk + kvh) * lkv + k0 + tid] = col_acc;
}

// colsum[b, col] = sum over kv heads, in order, of the partial column sums
__global__ void colsum_merge_kernel(const float* __restrict__ partial, float* __restrict__ colsum,
                                    int b, int hk, int lkv) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)b * lkv) return;
  const size_t bi = i / lkv, col = i % lkv;
  float s = 0.f;
  for (int kh = 0; kh < hk; ++kh) s += partial[(bi * hk + kh) * lkv + col];
  colsum[i] = s;
}

template <typename T, int D>
cudaError_t colsum_launch_t(const void* qp, const void* lse_p, const void* pos, const void* k,
                            void* partial, void* colsum, int b, int h, int hk, int np, int lq,
                            int lkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = colsum_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(probe_colsum_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lkv + PC_BK - 1) / PC_BK, b, hk);
  probe_colsum_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qp), static_cast<const float*>(lse_p), static_cast<const int*>(pos),
      static_cast<const T*>(k), static_cast<float*>(partial), h, hk, np, lkv,
      causal ? lkv - lq : 0, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = b * lkv;
  colsum_merge_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(colsum), b, hk, lkv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t colsum_launch_d(int d, const void* qp, const void* lse_p, const void* pos,
                            const void* k, void* partial, void* colsum, int b, int h, int hk,
                            int np, int lq, int lkv, int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return colsum_launch_t<T, 16>(qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
    case 32: return colsum_launch_t<T, 32>(qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
    case 64: return colsum_launch_t<T, 64>(qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
    case 128: return colsum_launch_t<T, 128>(qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* zc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (b,h,lq,d), k/v (b,hk,lkv,d), all bf16 or all f32, contiguous.
// out (b,h,lq,d) in q's type, lse (b,h,lq) f32.  d in {16, 32, 64, 128}.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                void* lse, int b, int h, int hk, int lq, int lkv, int d,
                                int causal, float scale, int is_bf16, void* stream) {
  if (hk <= 0 || h % hk || (causal && lkv < lq)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? flash_launch_d<__nv_bfloat16>(d, q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s)
      : flash_launch_d<float>(d, q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s);
  return static_cast<int>(err);
}

// qp (b,h,np,d) and k (b,hk,lkv,d) in one type (bf16 or f32); lse_p (b,h,np) f32;
// pos (b,np) int32, < 0 = padding row.  Scratch partial (b,hk,lkv) f32.
// colsum (b,lkv) f32.
extern "C" int probe_colsum_launch(const void* qp, const void* lse_p, const void* pos,
                                   const void* k, void* partial, void* colsum, int b, int h,
                                   int hk, int np, int lq, int lkv, int d, int causal,
                                   float scale, int is_bf16, void* stream) {
  if (hk <= 0 || h % hk) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? colsum_launch_d<__nv_bfloat16>(d, qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s)
      : colsum_launch_d<float>(d, qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
  return static_cast<int>(err);
}
