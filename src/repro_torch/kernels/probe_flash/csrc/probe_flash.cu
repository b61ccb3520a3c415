// Prefill attention with the ZipCache probe side-output, for Hopper sm_90a.
//
// flash_fwd replaces src/repro/kernels/probe_flash/kernel.py::flash_fwd
// (body _flash_kernel): FlashAttention-2 causal forward with an f32 LSE.
// probe_colsum replaces ::probe_colsum (body _probe_colsum_kernel): for the
// probe rows, sum_rows exp(q.k * d^-1/2 - lse) per key column, causal and
// pad-row masked, averaged over heads (paper Eq. 9 numerator).
//
// Bound on the H100: operations.  At yi-6b prefill widths (d = 128,
// 1024 tokens) attention does ~128 multiply-adds per byte it reads.
//
// Head dims: flash_fwd takes a q/k head dim DQK and a v head dim DV, one
// instantiation per pair: (d, d) for d in 16, 32, 64, 128 (GQA), and
// (192, 128) for DeepSeek-V2's MLA prefill (q/k = nope 128 + rope 64, v
// 128) with (32, 16) its smoke width.  The Q/K tiles and the score product
// run over DQK, the V tiles, the output accumulator and the output over DV;
// the LSE is per row as before.  probe_colsum reads no V and takes d in 16,
// 32, 64, 128 and 192.
//
// flash_fwd design, bf16 (the main path): FlashAttention-2 on the tensor
// cores, mma.sync m16n8k16 with a 2-stage cp.async K/V ring; see
// flash_fwd_tc_kernel.  The f32 instantiation, which no serving path runs,
// stays on the CUDA cores: one CTA of 128 threads per (q block of 64 rows,
// head, batch), the kv axis a loop inside the CTA (the TPU kernel carried
// acc/m/l across sequential grid steps in VMEM), acc in registers (each
// thread owns 4 rows x D/8 columns) and m/l per row reduced across the 8
// threads that share a row; each 32-column K (transposed) and V tile goes
// through shared memory.  Both read k[:, h / g] for GQA (K/V are never
// repeated in memory) and skip blocks wholly above the causal diagonal.
//
// probe_colsum design, bf16 (the main path): on the tensor cores, one CTA
// of 4 warps per (64-column kv block, hpc query heads of one kv group,
// batch row), the host choosing hpc so the grid keeps about four CTAs per
// SM (a batch-1 admission at a 1024-token prompt launches 512 CTAs of one
// head each); see probe_colsum_tc_kernel.  Each CTA writes one partial
// column sum for its heads, and a second small kernel adds the partials in
// head order and divides by h.  The f32 instantiation, which no serving path
// runs, stays on the CUDA cores: one CTA per (32-column kv block, batch, kv
// head) stages its K tile once and loops over the g query heads of the
// group and the 32-row probe blocks inside, writing one partial per kv
// head.  Every value has one writer and there are no float atomics, so the
// sums, and the saliency ties they decide, are deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// ---------------------------------------------------------------------------
// flash_fwd
// ---------------------------------------------------------------------------
constexpr int FA_BQ = 64;
constexpr int FA_BK = 32;

template <int D, int DV>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (FA_BQ * (D + 1) + D * (FA_BK + 1) + FA_BK * DV + FA_BQ * (FA_BK + 1));
}

// D: the q/k head dim; DV: the v head dim (DV == D but for MLA)
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int h, int hk, int lq, int lkv,
                 int diag, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [FA_BQ][D + 1], pre-scaled
  float* Kt = Qs + FA_BQ * (D + 1);          // [D][FA_BK + 1], transposed
  float* Vs = Kt + D * (FA_BK + 1);          // [FA_BK][DV]
  float* Ps = Vs + FA_BK * DV;               // [FA_BQ][FA_BK + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;   // rows ty*4 .. ty*4+3
  const int tx = tid & 7;    // columns tx + 8*j
  const int q0 = blockIdx.x * FA_BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const T* qh = q + ((size_t)b * h + head) * lq * D;
  const T* kh = k + ((size_t)b * hk + kvh) * lkv * D;
  const T* vh = v + ((size_t)b * hk + kvh) * lkv * DV;

  for (int e = tid; e < FA_BQ * D; e += THREADS) {
    const int r = e / D, j = e % D;
    Qs[r * (D + 1) + j] = (q0 + r < lq) ? to_f32(qh[(size_t)(q0 + r) * D + j]) * scale : 0.f;
  }

  constexpr int NC = DV / 8;
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
      Kt[j * (FA_BK + 1) + s] = k0 + s < lkv ? to_f32(kh[(size_t)(k0 + s) * D + j]) : 0.f;
    }
    for (int e = tid; e < FA_BK * DV; e += THREADS) {
      const int s = e / DV, j = e % DV;
      Vs[s * DV + j] = k0 + s < lkv ? to_f32(vh[(size_t)(k0 + s) * DV + j]) : 0.f;
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
        const float vv = Vs[s * DV + tx + 8 * c];
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
    T* orow = out + (((size_t)b * h + head) * lq + row) * DV;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 8 * c] = from_f32<T>(acc[i][c] / l);
    if (tx == 0) lse[((size_t)b * h + head) * lq + row] = m_i[i] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// flash_fwd, bf16 on the tensor cores (the main path's instantiation)
// ---------------------------------------------------------------------------
// A CTA of 4 warps takes TC_BQ = 64 query rows of one (batch, head); each
// warp owns 16 rows, so a row's max and sum stay inside one quad of lanes.
// S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in, f32 out) with
// fragments from ldmatrix (.trans for V).  Q's fragments stay in registers
// for the whole KV loop.  K/V tiles of TC_BK = 64 rows go through a 2-stage
// cp.async ring (16-byte copies, rows past lkv zero-filled), so tile n+1
// loads while tile n computes.  Shared rows are padded by 16 bytes, which
// keeps ldmatrix's eight row addresses on distinct banks.
//
// Numerics, as the reference: S comes from the unchanged bf16 inputs (the
// products are exact in f32), the scale multiplies the f32 scores, m and l
// come from the f32 scores and probabilities, and only the A operand of
// P V is P rounded to bf16.  The softmax runs in base 2 (scores times
// scale * log2 e, exp2f), which saves a multiply and a range reduction per
// element over expf; m converts back to base e for the LSE.  Only tiles that cross the causal diagonal or
// the lkv edge are masked; tiles wholly above the diagonal are skipped.
constexpr int TC_BQ = 64;
constexpr int TC_BK = 64;

template <int D, int DV>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((TC_BQ + 2 * TC_BK) * (D + 8) + 2 * TC_BK * (DV + 8));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `full` false zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int h, int hk, int lq, int lkv, int diag,
                    int causal, float scale) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  constexpr int LD = D + 8;        // Q/K shared row stride in elements (16-byte pad)
  constexpr int LDV = DV + 8;      // V shared row stride
  constexpr int CPR = D / 8;       // 16-byte chunks per Q/K row
  constexpr int CPRV = DV / 8;     // 16-byte chunks per V row
  constexpr int NT = TC_BK / 8;    // score n-tiles per warp
  constexpr int DT = DV / 8;       // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TC_BQ][LD]
  __nv_bfloat16* Ks = Qs + TC_BQ * LD;                              // [2][TC_BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * TC_BK * LD;                          // [2][TC_BK][LDV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * TC_BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const __nv_bfloat16* qh = q + ((size_t)b * h + head) * lq * D;
  const __nv_bfloat16* kh = k + ((size_t)b * hk + kvh) * lkv * D;
  const __nv_bfloat16* vh = v + ((size_t)b * hk + kvh) * lkv * DV;

  for (int e = tid; e < TC_BQ * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool in = q0 + r < lq;
    cp_async16(Qs + r * LD + c, qh + (in ? (size_t)(q0 + r) * D + c : 0), in);
  }
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * TC_BK;
    if constexpr (D == DV) {  // one loop for both tiles (the GQA widths)
      for (int e = tid; e < TC_BK * CPR; e += THREADS) {
        const int r = e / CPR, c = (e % CPR) * 8;
        const bool in = k0 + r < lkv;
        const size_t off = in ? (size_t)(k0 + r) * D + c : 0;
        cp_async16(Ks + (stage * TC_BK + r) * LD + c, kh + off, in);
        cp_async16(Vs + (stage * TC_BK + r) * LDV + c, vh + off, in);
      }
    } else {
      for (int e = tid; e < TC_BK * CPR; e += THREADS) {
        const int r = e / CPR, c = (e % CPR) * 8;
        const bool in = k0 + r < lkv;
        cp_async16(Ks + (stage * TC_BK + r) * LD + c, kh + (in ? (size_t)(k0 + r) * D + c : 0),
                   in);
      }
      for (int e = tid; e < TC_BK * CPRV; e += THREADS) {
        const int r = e / CPRV, c = (e % CPRV) * 8;
        const bool in = k0 + r < lkv;
        cp_async16(Vs + (stage * TC_BK + r) * LDV + c,
                   vh + (in ? (size_t)(k0 + r) * DV + c : 0), in);
      }
    }
  };
  const int kv_end = causal ? min(lkv, q0 + TC_BQ + diag) : lkv;
  const int n_tiles = (kv_end + TC_BK - 1) / TC_BK;
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + gr;  // this thread's rows: row0, row0 + 8
  const float sscale = scale * 1.4426950408889634f;  // scores in log2 units

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + (t & 1) * TC_BK * LD;
    const __nv_bfloat16* Vt = Vs + (t & 1) * TC_BK * LDV;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Kt + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    const int k0 = t * TC_BK;
    const bool edge = k0 + TC_BK > lkv || (causal && k0 + TC_BK - 1 > q0 + diag);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sscale;
        if (edge) {
          const int row = row0 + (e >> 1) * 8, col = k0 + j * 8 + tg * 2 + (e & 1);
          if (col >= lkv || (causal && col > row + diag)) x = NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_r[i], mx[i]);
      alpha[i] = exp2f(m_r[i] - m_new[i]);
      m_r[i] = m_new[i];
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[j][e] > 0.5f * NEG_INF ? exp2f(s[j][e] - m_new[e >> 1]) : 0.f;
        l_r[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      o[c][0] *= alpha[0];
      o[c][1] *= alpha[0];
      o[c][2] *= alpha[1];
      o[c][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vt + (kk * 16 + (lane & 15)) * LDV + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= lq) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * h + head) * lq + row) * DV;
#pragma unroll
    for (int c = 0; c < DT; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + c * 8 + tg * 2) =
          __floats2bfloat162_rn(o[c][2 * i] / l, o[c][2 * i + 1] / l);
    if (tg == 0) lse[((size_t)b * h + head) * lq + row] = m_r[i] * 0.6931471805599453f + logf(l);
  }
}

template <int D, int DV>
cudaError_t flash_tc_launch(const void* q, const void* k, const void* v, void* out, void* lse,
                            int b, int h, int hk, int lq, int lkv, int causal, float scale,
                            cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + TC_BQ - 1) / TC_BQ, h, b);
  flash_fwd_tc_kernel<D, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), h, hk, lq, lkv, causal ? lkv - lq : 0, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t flash_launch_t(const void* q, const void* k, const void* v, void* out, void* lse,
                           int b, int h, int hk, int lq, int lkv, int causal, float scale,
                           cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + FA_BQ - 1) / FA_BQ, h, b);
  flash_fwd_kernel<T, D, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), h, hk, lq, lkv,
      causal ? lkv - lq : 0, causal, scale);
  return cudaGetLastError();
}

// one instantiation per (q/k, v) head-dim pair
#define FLASH_PAIRS(X) X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(192, 128) X(32, 16)

template <typename T>
cudaError_t flash_launch_d(int d, int dv, const void* q, const void* k, const void* v, void* out,
                           void* lse, int b, int h, int hk, int lq, int lkv, int causal,
                           float scale, cudaStream_t s) {
#define FLASH_CASE(D, DV)                                                                    \
  if (d == D && dv == DV) {                                                                  \
    if constexpr (std::is_same<T, __nv_bfloat16>::value)                                     \
      return flash_tc_launch<D, DV>(q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s); \
    else                                                                                     \
      return flash_launch_t<T, D, DV>(q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s); \
  }
  FLASH_PAIRS(FLASH_CASE)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// probe_colsum, f32 on the CUDA cores
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
        col_acc += s;
      }
    }
  }
  if (tid < PC_BK && k0 + tid < lkv)
    partial[((size_t)b * hk + kvh) * lkv + k0 + tid] = col_acc;
}

// probe_colsum on the tensor cores (bf16).  A CTA of 4 warps owns PT_BK =
// 64 key columns of one batch row for hpc query heads of one kv group (the
// host picks hpc; 1 gives the most CTAs): it loads that K tile once with
// cp.async and streams the probe rows of its heads through a 2-stage
// cp.async ring of PT_BP = 64-row Q tiles, one 16-row slice per warp.
// S = Q K^T runs as mma.sync m16n8k16 (bf16 in, f32 accumulate) with
// ldmatrix fragments, as in flash_fwd_tc_kernel; p = exp(s * scale - lse)
// runs in base 2 on the f32 fragments, with scale * log2 e and lse * log2 e
// folded into one FMA.
//
// Causal skipping: before the loop, the warps scan the Q tiles (one tile a
// warp at a time) for those whose largest row position reaches the CTA's
// first column (max pos + diag >= k0), and one thread lists them in order;
// the ring streams only those, head after head.  A warp also skips
// its 16-row slice when no row of it reaches k0.  Neither test relies on
// the rows being sorted.  Elements of a live slice are masked one by one
// (pad rows pos < 0, the causal diagonal, columns past lkv).
//
// Determinism: each thread sums its probabilities over its heads and tiles
// in order (its columns j * 8 + 2 tg, + 1 of rows gr and gr + 8); the 8 row
// groups of a warp are combined by a fixed __shfl_xor butterfly, the 4
// warps in warp order through shared memory, and the CTAs' partials (one
// per hpc heads) by the merge kernel in head order.  No float atomics: two
// calls give bitwise-equal sums.
constexpr int PT_BK = 64;   // key columns per CTA
constexpr int PT_BP = 64;   // probe rows per Q tile: 16 per warp

template <int D>
constexpr size_t colsum_tc_smem_bytes(int n_tiles) {
  return sizeof(__nv_bfloat16) * (PT_BK + 2 * PT_BP) * (D + 8) +
         sizeof(float) * (THREADS / 32) * PT_BK + sizeof(int) * (2 * n_tiles + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
probe_colsum_tc_kernel(const __nv_bfloat16* __restrict__ qp, const float* __restrict__ lse_p,
                       const int* __restrict__ pos, const __nv_bfloat16* __restrict__ k,
                       float* __restrict__ partial, int h, int hk, int hpc, int np, int lkv,
                       int diag, int causal, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 8;        // shared row stride in elements (16-byte pad)
  constexpr int CPR = D / 8;       // 16-byte chunks per row
  constexpr int NT = PT_BK / 8;    // score n-tiles per warp
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [PT_BK][LD]
  __nv_bfloat16* Qs = Ks + PT_BK * LD;                              // [2][PT_BP][LD]
  float* red = reinterpret_cast<float*>(Qs + 2 * PT_BP * LD);       // [WARPS][PT_BK]
  int* live = reinterpret_cast<int*>(red + (THREADS / 32) * PT_BK);  // count, then tiles
  const int n_tiles = (np + PT_BP - 1) / PT_BP;
  int* flag = live + 1 + n_tiles;                                      // [n_tiles]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int k0 = blockIdx.x * PT_BK;
  const int head0 = blockIdx.y * hpc;  // this CTA's heads: head0 .. head0 + hpc - 1
  const int b = blockIdx.z;
  const int kvh = head0 / (h / hk);
  const __nv_bfloat16* kh = k + ((size_t)b * hk + kvh) * lkv * D;
  const int* pb = pos + (size_t)b * np;

  for (int e = tid; e < PT_BK * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool in = k0 + r < lkv;
    cp_async16(Ks + r * LD + c, kh + (in ? (size_t)(k0 + r) * D + c : 0), in);
  }
  for (int t = warp; t < n_tiles; t += THREADS / 32) {  // which Q tiles reach k0
    int mx = -1;
    for (int r = t * PT_BP + lane; r < min(np, (t + 1) * PT_BP); r += 32)
      mx = max(mx, __ldg(pb + r));
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) flag[t] = mx >= 0 && (!causal || mx + diag >= k0);
  }
  __syncthreads();
  if (tid == 0) {  // the live tiles, in order
    int n = 0;
    for (int t = 0; t < n_tiles; ++t)
      if (flag[t]) live[1 + n++] = t;
    live[0] = n;
  }
  __syncthreads();
  const int n_live = live[0], n_items = hpc * n_live;  // item i: head i / n_live
  auto load_q = [&](int i, int stage) {
    const int t = live[1 + i % n_live];
    const __nv_bfloat16* qh = qp + ((size_t)b * h + head0 + i / n_live) * np * D;
    for (int e = tid; e < PT_BP * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 8, row = t * PT_BP + r;
      const bool in = row < np;
      cp_async16(Qs + (stage * PT_BP + r) * LD + c, qh + (in ? (size_t)row * D + c : 0), in);
    }
  };
  if (n_items > 0) load_q(0, 0);
  cp_async_commit();

  float cs[NT][2];  // this thread's column sums: columns j * 8 + tg * 2 + c of the block
#pragma unroll
  for (int j = 0; j < NT; ++j) cs[j][0] = cs[j][1] = 0.f;
  const float sscale = scale * LOG2E;

  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) load_q(i + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* lh = lse_p + ((size_t)b * h + head0 + i / n_live) * np;
    const int row0 = live[1 + i % n_live] * PT_BP + warp * 16 + gr;  // rows row0, row0 + 8
    int pr[2];
    float l2[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = row0 + 8 * a;
      pr[a] = row < np ? __ldg(pb + row) : -1;
      l2[a] = row < np ? __ldg(lh + row) * LOG2E : 0.f;
    }
    int mx = max(pr[0], pr[1]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (mx >= 0 && (!causal || mx + diag >= k0)) {  // warp-uniform
      const __nv_bfloat16* Qt = Qs + (i & 1) * PT_BP * LD;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qf[4];
        ldmatrix_x4(qf, Qt + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, Ks + (n2 * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * n2], qf, kb[0], kb[1]);
          mma_bf16(s[2 * n2 + 1], qf, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = e >> 1, col = k0 + j * 8 + tg * 2 + (e & 1);
          const bool valid = pr[a] >= 0 && col < lkv && (!causal || pr[a] + diag >= col);
          cs[j][e & 1] += valid ? exp2f(fmaf(s[j][e], sscale, -l2[a])) : 0.f;
        }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) cs[j][c] += __shfl_xor_sync(0xffffffffu, cs[j][c], o);
  if (gr == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      red[warp * PT_BK + j * 8 + tg * 2] = cs[j][0];
      red[warp * PT_BK + j * 8 + tg * 2 + 1] = cs[j][1];
    }
  }
  __syncthreads();
  if (tid < PT_BK && k0 + tid < lkv) {
    float acc = red[tid];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) acc += red[w * PT_BK + tid];
    partial[((size_t)b * gridDim.y + blockIdx.y) * lkv + k0 + tid] = acc;
  }
}

// colsum[b, col] = (sum over the n_part partials of row b, in order) / h
__global__ void colsum_merge_kernel(const float* __restrict__ partial, float* __restrict__ colsum,
                                    int b, int n_part, int lkv, int h) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)b * lkv) return;
  const size_t bi = i / lkv, col = i % lkv;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p) s += partial[(bi * n_part + p) * lkv + col];
  colsum[i] = s / static_cast<float>(h);
}

cudaError_t colsum_merge(const void* partial, void* colsum, int b, int n_part, int lkv, int h,
                         cudaStream_t stream) {
  const int n = b * lkv;
  colsum_merge_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(colsum), b, n_part, lkv, h);
  return cudaGetLastError();
}

template <int D>
cudaError_t colsum_tc_launch(const void* qp, const void* lse_p, const void* pos, const void* k,
                             void* partial, void* colsum, int b, int h, int hk, int hpc, int np,
                             int lq, int lkv, int causal, float scale, cudaStream_t stream) {
  if (hpc <= 0 || (h / hk) % hpc) return cudaErrorInvalidValue;
  const size_t smem = colsum_tc_smem_bytes<D>((np + PT_BP - 1) / PT_BP);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(probe_colsum_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lkv + PT_BK - 1) / PT_BK, h / hpc, b);
  probe_colsum_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qp), static_cast<const float*>(lse_p),
      static_cast<const int*>(pos), static_cast<const __nv_bfloat16*>(k),
      static_cast<float*>(partial), h, hk, hpc, np, lkv, causal ? lkv - lq : 0, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colsum_merge(partial, colsum, b, h / hpc, lkv, h, stream);
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
  return colsum_merge(partial, colsum, b, hk, lkv, h, stream);
}

template <typename T>
cudaError_t colsum_launch_d(int d, const void* qp, const void* lse_p, const void* pos,
                            const void* k, void* partial, void* colsum, int b, int h, int hk,
                            int hpc, int np, int lq, int lkv, int causal, float scale,
                            cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (d) {
      case 16: return colsum_tc_launch<16>(qp, lse_p, pos, k, partial, colsum, b, h, hk, hpc, np, lq, lkv, causal, scale, s);
      case 32: return colsum_tc_launch<32>(qp, lse_p, pos, k, partial, colsum, b, h, hk, hpc, np, lq, lkv, causal, scale, s);
      case 64: return colsum_tc_launch<64>(qp, lse_p, pos, k, partial, colsum, b, h, hk, hpc, np, lq, lkv, causal, scale, s);
      case 128: return colsum_tc_launch<128>(qp, lse_p, pos, k, partial, colsum, b, h, hk, hpc, np, lq, lkv, causal, scale, s);
      case 192: return colsum_tc_launch<192>(qp, lse_p, pos, k, partial, colsum, b, h, hk, hpc, np, lq, lkv, causal, scale, s);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (d) {
      case 16: return colsum_launch_t<T, 16>(qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
      case 32: return colsum_launch_t<T, 32>(qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
      case 64: return colsum_launch_t<T, 64>(qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
      case 128: return colsum_launch_t<T, 128>(qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
      case 192: return colsum_launch_t<T, 192>(qp, lse_p, pos, k, partial, colsum, b, h, hk, np, lq, lkv, causal, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

extern "C" const char* zc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (b,h,lq,d), k (b,hk,lkv,d), v (b,hk,lkv,dv), all bf16 or all f32, contiguous.
// out (b,h,lq,dv) in q's type, lse (b,h,lq) f32.  (d, dv) one of FLASH_PAIRS.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                void* lse, int b, int h, int hk, int lq, int lkv, int d, int dv,
                                int causal, float scale, int is_bf16, void* stream) {
  if (hk <= 0 || h % hk || (causal && lkv < lq)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? flash_launch_d<__nv_bfloat16>(d, dv, q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s)
      : flash_launch_d<float>(d, dv, q, k, v, out, lse, b, h, hk, lq, lkv, causal, scale, s);
  return static_cast<int>(err);
}

// qp (b,h,np,d) and k (b,hk,lkv,d) in one type (bf16 or f32); lse_p (b,h,np) f32;
// pos (b,np) int32, < 0 = padding row.  Scratch partial f32: (b,h/hpc,lkv)
// for bf16 (one partial per hpc query heads, hpc dividing h / hk),
// (b,hk,lkv) for f32 (per kv head; hpc unused).  colsum (b,lkv) f32.
extern "C" int probe_colsum_launch(const void* qp, const void* lse_p, const void* pos,
                                   const void* k, void* partial, void* colsum, int b, int h,
                                   int hk, int hpc, int np, int lq, int lkv, int d, int causal,
                                   float scale, int is_bf16, void* stream) {
  if (hk <= 0 || h % hk || b <= 0 || lkv <= 0 || np < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? colsum_launch_d<__nv_bfloat16>(d, qp, lse_p, pos, k, partial, colsum, b, h, hk, hpc, np, lq, lkv, causal, scale, s)
      : colsum_launch_d<float>(d, qp, lse_p, pos, k, partial, colsum, b, h, hk, hpc, np, lq, lkv, causal, scale, s);
  return static_cast<int>(err);
}
