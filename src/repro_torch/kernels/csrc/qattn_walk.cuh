// One-token GQA decode attention over the ZipCache stores of one decode
// layer, sm_90a: up to three segments (4-bit hi, 2-bit lo, raw bf16 staging
// window) in one split kernel and one ordered merge kernel.  The walk is
// shared by two layouts, chosen by the template parameter PAGED:
//   - paged (paged_qattn.cu): the payload lives in page pools (P, hk, page,
//     c) addressed through a (b, npp) page table; each lane loads
//     table[b, slot / page] and forms the token row ((pid * hk + h) * page
//     + slot % page) of the pool;
//   - contiguous (decode_qattn.cu): each store is one (b, hk, S, c) tensor,
//     the token row is (b * hk + h) * S + slot, and no table is read.
// The small per-slot parameters are dense in both.  Slots with pos < 0 are
// masked, as are slots at or past the segment's valid length s_seg (so no
// operand needs padding).
//
// Dequant (quantized segments): K is channelwise, k = (code - zero_c) *
// scale_c; V is CST, v = ((code - zero_t) * scale_t) * c_chan.  Codes are
// packed LSB-first, 8 / bits to a byte.  Both round to the store dtype
// before use, as QuantizedTensor.dequantize does on the reference's live
// path (the TPU kernels' k_dtype / v_dtype).  Raw segments hold bf16 or
// f32 values, which pass through.  A row with no valid slot gives l = 0
// and acc = 0.
//
// Outputs, per query head: the merged flash stats (acc or the normalized
// output in q's dtype, m, l), and when asked the per-slot p = exp(s -
// m_run) over the concatenated slots of the segments, with the running max
// m_run it is relative to, so the caller rebuilds the softmax row as
// p * exp(m_run - m) / l.
//
// Bound on the H100: bytes.  A decode step reads every live code once and
// does ~2 multiply-adds per dequantized element, so the kernel is set by
// latency: it needs many independent 16-byte loads in flight and short
// dependent chains per thread.  The grid is (kv head, slot, split) over the
// layer's concatenated walk of 32-slot blocks, sized on the whole layer
// (about four CTAs per SM).  A CTA stages q and the per-channel parameters
// of every segment once into shared memory (f32), then each of its 4 warps
// takes 8 slots of every block it walks, with its own online softmax and
// no __syncthreads until the end:
//   - 4 lanes per slot: each reads one run of D / 4 channels of the slot's
//     code row at once (16 bytes for 4-bit codes at d = 128, 64 bytes of
//     bf16 values), unpacks LSB-first, dequantizes and forms its part of the
//     g = h / hk scores against q; two shuffles complete each score;
//   - the row max over the pass is a warp shuffle; lanes keep partial l;
//   - each lane dequantizes its run of the V row into a per-warp shared
//     tile, and P V gives each lane 4 channels over the pass's 8 slots.
// Scores and P V are f32 FMA on the CUDA cores (g = 8 would need padding to
// 16 for mma).  The CTA merges its warps in order and writes one partial
// (acc, m, l); the merge kernel combines all partials of all segments in
// segment-then-split order, one CTA per (slot, head), and writes the
// output: deterministic, no float atomics.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace qattn_walk {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int LPS = 4;            // lanes per slot: each reads one run of D / 4 channels
constexpr int SPW = 32 / LPS;     // slots per warp pass
constexpr int BS = WARPS * SPW;   // slots per block of the walk: one pass of the CTA
constexpr int QPAD = 4;           // floats between the runs of a shared row
constexpr int MAX_SEGS = 3;
constexpr int MAX_SPLITS = 4096;

// A segment as the host describes it (ctypes mirrors this layout).
struct SegDesc {
  const void* kpool;   // paged: (P, hk, page, ck); contiguous: (b, hk, s_seg, ck).
  const void* vpool;   //   int8 codes, or raw values
  const void* ks;      // (b, hk, 1, d) K channel scale / zero, quantized only
  const void* kz;
  const void* vcs;     // (b, hk, 1, d) V channel scale, quantized only
  const void* vts;     // (b, hk, s_seg, 1) V token scale / zero, quantized only
  const void* vtz;
  const int* pos;      // (b, s_seg) int32, < 0 = empty
  const int* table;    // paged: (b, npp) int32 physical page ids; contiguous: unused
  int npp, page, k_bits, v_bits;  // npp, page: paged only; bits >= 16: raw
  int s_seg;           // valid slots (paged: <= npp * page; contiguous: the store's S)
  int t_bf16;          // parameter dtype (quantized) or payload dtype (raw): bf16 or f32
};

struct Seg {
  SegDesc d;
  int k_fmt, v_fmt;    // 2, 4, 8: packed codes; 16: raw bf16; 32: raw f32
  int blk0, slot0;     // first block of the layer walk, first concatenated slot
};

struct Layer {
  Seg seg[MAX_SEGS];
  int n_seg, n_blk, s_total;
};

__device__ __forceinline__ float bf16_bits(uint32_t lo16) { return __uint_as_float(lo16 << 16); }

// round to the store dtype (bf16 or f32) and lift back to f32
template <bool BF16>
__device__ __forceinline__ float store_round(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

// field i of a 32-bit word of format FMT, as f32
template <int FMT>
__device__ __forceinline__ float decode(uint32_t w, int i) {
  if constexpr (FMT == 32) return __uint_as_float(w);
  else if constexpr (FMT == 16) return bf16_bits((w >> (16 * i)) & 0xffffu);
  else return static_cast<float>((w >> (FMT * i)) & ((1u << FMT) - 1u));
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float ld_param(const void* p, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Shared rows of D channels (q, the per-channel parameters, the V tile) are
// stored in LPS runs of D / LPS channels, each run QPAD floats further
// along: the LPS lanes of a slot then read and write distinct banks.
__host__ __device__ constexpr int padded(int d) { return d + LPS * QPAD; }
template <int D>
__device__ __forceinline__ int pidx(int c) { return c + (c / (D / LPS)) * QPAD; }

// This lane's NCH fields of a row of format FMT, loaded at once (16-byte
// loads where the run is 16 bytes or more): fn(c, x[4]) sees the decoded
// fields of run channels c .. c + 3.
template <int FMT, int NCH, typename F>
__device__ __forceinline__ void walk_run(const uint8_t* p, F&& fn) {
  constexpr int NB = NCH * FMT / 8;       // bytes of the run
  constexpr int NW = NB >= 4 ? NB / 4 : 1;
  constexpr int PER = 32 / FMT;           // fields per 32-bit word
  uint32_t wd[NW];
  if constexpr (NB >= 16) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      wd[4 * i] = u.x; wd[4 * i + 1] = u.y; wd[4 * i + 2] = u.z; wd[4 * i + 3] = u.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    wd[0] = u.x; wd[1] = u.y;
  } else if constexpr (NB == 4) {
    wd[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (NB == 2) {
    wd[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    wd[0] = __ldg(p);
  }
#pragma unroll
  for (int c = 0; c < NCH; c += 4) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = decode<FMT>(wd[(c + i) / PER], (c + i) % PER);
    fn(c, x);
  }
}

// this lane's run of the slot row: its address, and the padded offset of its channels
template <int FMT, int D>
__device__ __forceinline__ const uint8_t* run_ptr(const void* pool, long long row, int qt) {
  return static_cast<const uint8_t*>(pool) + row * (D * FMT / 8) + qt * (D / LPS * FMT / 8);
}

// sc[r] += q_r . k over this lane's run of the slot's K row (qs pre-scaled)
template <int FMT, bool RB, int D, int G>
__device__ __forceinline__ void k_run(const Seg& sg, long long row, int qt, const float* kp,
                                      const float* qs, float (&sc)[G]) {
  constexpr int NCH = D / LPS;
  const int cb = qt * (NCH + QPAD);
  walk_run<FMT, NCH>(run_ptr<FMT, D>(sg.d.kpool, row, qt), [&](int c, float (&x)[4]) {
    if constexpr (FMT <= 8) {
      const float4 s4 = ld4(kp + cb + c), z4 = ld4(kp + padded(D) + cb + c);
      x[0] = store_round<RB>((x[0] - z4.x) * s4.x);
      x[1] = store_round<RB>((x[1] - z4.y) * s4.y);
      x[2] = store_round<RB>((x[2] - z4.z) * s4.z);
      x[3] = store_round<RB>((x[3] - z4.w) * s4.w);
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float4 q4 = ld4(qs + r * padded(D) + cb + c);
      sc[r] += q4.x * x[0] + q4.y * x[1] + q4.z * x[2] + q4.w * x[3];
    }
  });
}

// this lane's run of the slot's dequantized V row -> vrow (padded)
template <int FMT, bool RB, int D>
__device__ __forceinline__ void v_run(const Seg& sg, long long row, int qt, float ts, float tz,
                                      const float* vcs, float* vrow) {
  constexpr int NCH = D / LPS;
  const int cb = qt * (NCH + QPAD);
  walk_run<FMT, NCH>(run_ptr<FMT, D>(sg.d.vpool, row, qt), [&](int c, float (&x)[4]) {
    if constexpr (FMT <= 8) {
      const float4 c4 = ld4(vcs + cb + c);
      x[0] = store_round<RB>(((x[0] - tz) * ts) * c4.x);
      x[1] = store_round<RB>(((x[1] - tz) * ts) * c4.y);
      x[2] = store_round<RB>(((x[2] - tz) * ts) * c4.z);
      x[3] = store_round<RB>(((x[3] - tz) * ts) * c4.w);
    }
    *reinterpret_cast<float4*>(vrow + cb + c) = make_float4(x[0], x[1], x[2], x[3]);
  });
}

__device__ __forceinline__ const Seg& seg_at(const Layer& L, int si) {
  return si == 0 ? L.seg[0] : (si == 1 ? L.seg[1] : L.seg[2]);
}

// Where a lane's slot of one block lives: the raw loads only, so a block's
// loads can be issued while the previous block computes.
struct SlotRef {
  int si, slot, pos, pid;  // pid: the physical page (paged layout only)
  uint32_t ts, tz;  // V token scale / zero bits (bf16 or f32) of a quantized segment
};

template <bool PAGED>
__device__ __forceinline__ SlotRef slot_ref(const Layer& L, int blk, int sub, int b, int hk,
                                            int kvh) {
  SlotRef r{0, 0, -1, 0, 0u, 0u};
  if (L.n_seg > 1 && blk >= L.seg[1].blk0) r.si = 1;
  if (L.n_seg > 2 && blk >= L.seg[2].blk0) r.si = 2;
  const Seg& sg = seg_at(L, r.si);
  r.slot = (blk - sg.blk0) * BS + sub;
  if (r.slot < sg.d.s_seg) {
    r.pos = __ldg(sg.d.pos + (size_t)b * sg.d.s_seg + r.slot);
    if constexpr (PAGED) r.pid = __ldg(sg.d.table + (size_t)b * sg.d.npp + r.slot / sg.d.page);
    if (sg.v_fmt <= 8) {
      const size_t ti = ((size_t)b * hk + kvh) * sg.d.s_seg + r.slot;
      if (sg.d.t_bf16) {
        r.ts = __ldg(static_cast<const unsigned short*>(sg.d.vts) + ti);
        r.tz = __ldg(static_cast<const unsigned short*>(sg.d.vtz) + ti);
      } else {
        r.ts = __ldg(static_cast<const unsigned int*>(sg.d.vts) + ti);
        r.tz = __ldg(static_cast<const unsigned int*>(sg.d.vtz) + ti);
      }
    }
  }
  return r;
}

// the token row of a slot in its segment's payload
template <bool PAGED>
__device__ __forceinline__ long long token_row(const Seg& sg, const SlotRef& r, int b, int hk,
                                               int kvh) {
  if constexpr (PAGED) return ((long long)r.pid * hk + kvh) * sg.d.page + r.slot % sg.d.page;
  else return ((long long)b * hk + kvh) * sg.d.s_seg + r.slot;
}

__device__ __forceinline__ float param_bits(uint32_t v, bool bf16) {
  return bf16 ? bf16_bits(v) : __uint_as_float(v);
}

// dynamic shared memory of the split kernel
__host__ __device__ constexpr size_t smem_bytes(int d, int g) {
  return sizeof(float) * ((g + MAX_SEGS * 3 + WARPS * SPW) * padded(d) + WARPS * (SPW + 1) * g);
}

template <bool PAGED, int D, int G>
__global__ void __launch_bounds__(THREADS)
split_kernel(const void* __restrict__ q, int q_bf16, const Layer L,
             float* __restrict__ acc_part, float* __restrict__ m_part,
             float* __restrict__ l_part, float* __restrict__ p_out,
             float* __restrict__ mrun_out, int h, int hk, float scale, int bpc) {
  static_assert(D % (4 * LPS) == 0 && D <= 4 * 32, "P V gives each lane 4 channels");
  static_assert(G * D <= SPW * padded(D) && 3 <= SPW, "the warps' merge reuses the tiles");
  constexpr int PLD = padded(D);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [G][PLD], q * scale
  float* prm = qs + G * PLD;               // [MAX_SEGS][3][PLD]: ks, kz, vcs
  float* vbuf = prm + MAX_SEGS * 3 * PLD;  // [WARPS][SPW][PLD] V tiles
  float* pbuf = vbuf + WARPS * SPW * PLD;  // [WARPS][SPW][G] probabilities
  float* abuf = pbuf + WARPS * SPW * G;    // [WARPS][G] rescale factors

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sl = lane / LPS, qt = lane % LPS;  // slot of the warp's pass, run of its row
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const size_t bh = (size_t)b * hk + kvh;

  const int blk_end = min(L.n_blk, (split + 1) * bpc);
  // in flight already
  SlotRef cur = slot_ref<PAGED>(L, split * bpc, warp * SPW + sl, b, hk, kvh);
  {  // the group's g query rows: 16 bytes a thread
    const size_t q0 = ((size_t)b * h + kvh * G) * D;
    const int per = q_bf16 ? 8 : 4;
    for (int e = tid * per; e < G * D; e += THREADS * per) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const uint8_t*>(q) + (q0 + e) * (q_bf16 ? 2 : 4)));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      float x[8] = {};
      if (q_bf16) {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = bf16_bits((w[i / 2] >> (16 * (i % 2))) & 0xffffu);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < per) qs[((e + i) / D) * PLD + pidx<D>((e + i) % D)] = x[i] * scale;
    }
  }
  for (int si = 0; si < MAX_SEGS; ++si) {
    const SegDesc& d = si == 0 ? L.seg[0].d : (si == 1 ? L.seg[1].d : L.seg[2].d);
    if (si >= L.n_seg || d.k_bits >= 16) continue;
    for (int e = tid; e < D; e += THREADS) {
      prm[(si * 3 + 0) * PLD + pidx<D>(e)] = ld_param(d.ks, bh * D + e, d.t_bf16);
      prm[(si * 3 + 1) * PLD + pidx<D>(e)] = ld_param(d.kz, bh * D + e, d.t_bf16);
      prm[(si * 3 + 2) * PLD + pidx<D>(e)] = ld_param(d.vcs, bh * D + e, d.t_bf16);
    }
  }
  __syncthreads();

  float* vb = vbuf + warp * SPW * PLD;
  float* pb = pbuf + warp * SPW * G;
  float* vrow = vb + sl * PLD;
  const int c0 = lane * 4;
  const bool owns_c = c0 < D;
  // Softmax rows of this lane: where 4 divides g the 4 lanes of a slot
  // split the rows (a reduce-scatter completes their scores), else (g = 1,
  // 2, 3, 7) each lane holds every row and the run-0 lane owns the writes:
  // a scatter of 7 rows over 4 lanes would leave rows that no lane owns.
  static_assert(LPS == 4, "the reduce-scatter is written for 4 lanes per slot");
  constexpr bool SCATTER = G % LPS == 0;
  constexpr int R = SCATTER ? G / LPS : G;
  const int rbase = SCATTER ? ((qt >> 1) & 1) * (G / 2) + (qt & 1) * (G / 4) : 0;
  const bool owner = SCATTER || qt == 0;
  float* al = abuf + warp * G;      // the pass's rescale factors, per row
  float acc[G][4], m_r[R], l_r[R];  // l_r: the sum over this lane's slots
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    m_r[j] = NEG_INF;
    l_r[j] = 0.f;
  }

  for (int blk = split * bpc; blk < blk_end; ++blk) {
    const SlotRef nxt = blk + 1 < blk_end
                            ? slot_ref<PAGED>(L, blk + 1, warp * SPW + sl, b, hk, kvh)
                            : SlotRef{0, 0, -1, 0, 0u, 0u};
    const int si = cur.si, slot = cur.slot;
    const Seg& sg = seg_at(L, si);
    const bool valid = slot < sg.d.s_seg && cur.pos >= 0;
    const long long row = token_row<PAGED>(sg, cur, b, hk, kvh);
    const float ts = param_bits(cur.ts, sg.d.t_bf16), tz = param_bits(cur.tz, sg.d.t_bf16);
    float sc[G];
#pragma unroll
    for (int r = 0; r < G; ++r) sc[r] = 0.f;
    if (valid) {
      const float* kp = prm + si * 3 * PLD;
      const float* vcs = prm + (si * 3 + 2) * PLD;
      if (sg.d.t_bf16) {  // bf16 parameters / payload: values round to bf16
        switch (sg.k_fmt) {
          case 2: k_run<2, true, D, G>(sg, row, qt, kp, qs, sc); break;
          case 4: k_run<4, true, D, G>(sg, row, qt, kp, qs, sc); break;
          case 8: k_run<8, true, D, G>(sg, row, qt, kp, qs, sc); break;
          default: k_run<16, true, D, G>(sg, row, qt, kp, qs, sc); break;
        }
        switch (sg.v_fmt) {
          case 2: v_run<2, true, D>(sg, row, qt, ts, tz, vcs, vrow); break;
          case 4: v_run<4, true, D>(sg, row, qt, ts, tz, vcs, vrow); break;
          case 8: v_run<8, true, D>(sg, row, qt, ts, tz, vcs, vrow); break;
          default: v_run<16, true, D>(sg, row, qt, ts, tz, vcs, vrow); break;
        }
      } else {
        switch (sg.k_fmt) {
          case 2: k_run<2, false, D, G>(sg, row, qt, kp, qs, sc); break;
          case 4: k_run<4, false, D, G>(sg, row, qt, kp, qs, sc); break;
          case 8: k_run<8, false, D, G>(sg, row, qt, kp, qs, sc); break;
          default: k_run<32, false, D, G>(sg, row, qt, kp, qs, sc); break;
        }
        switch (sg.v_fmt) {
          case 2: v_run<2, false, D>(sg, row, qt, ts, tz, vcs, vrow); break;
          case 4: v_run<4, false, D>(sg, row, qt, ts, tz, vcs, vrow); break;
          case 8: v_run<8, false, D>(sg, row, qt, ts, tz, vcs, vrow); break;
          default: v_run<32, false, D>(sg, row, qt, ts, tz, vcs, vrow); break;
        }
      }
    } else {
      const int cb = qt * (D / LPS + QPAD);
#pragma unroll
      for (int c = 0; c < D / LPS; c += 4)
        *reinterpret_cast<float4*>(vrow + cb + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    float u[R];  // full scores of this lane's rows
    if constexpr (SCATTER) {
      constexpr int HALF = G / 2, QUART = G / 4;
      const bool hi = qt & 2, lo = qt & 1;
      float t[HALF];
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const float give = hi ? sc[j] : sc[HALF + j];
        t[j] = (hi ? sc[HALF + j] : sc[j]) + __shfl_xor_sync(0xffffffffu, give, 2);
      }
#pragma unroll
      for (int j = 0; j < QUART; ++j) {
        const float give = lo ? t[j] : t[QUART + j];
        u[j] = (lo ? t[QUART + j] : t[j]) + __shfl_xor_sync(0xffffffffu, give, 1);
      }
    } else {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        u[r] = sc[r] + __shfl_xor_sync(0xffffffffu, sc[r], 1);
        u[r] += __shfl_xor_sync(0xffffffffu, u[r], 2);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = rbase + j;
      const float s = valid ? u[j] : NEG_INF;
      float mx = s;
#pragma unroll
      for (int o = LPS; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[j], mx);
      const float alpha = expf(m_r[j] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l_r[j] = l_r[j] * alpha + (owner ? p : 0.f);
      m_r[j] = m_new;
      if (owner) {
        pb[sl * G + r] = p;
        if (sl == 0) al[r] = alpha;
        if (p_out != nullptr && slot < sg.d.s_seg) {
          const size_t o = ((size_t)b * h + kvh * G + r) * L.s_total + sg.slot0 + slot;
          p_out[o] = p;
          mrun_out[o] = m_new;
        }
      }
    }
    __syncwarp();
    if (owns_c) {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float alpha = al[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] *= alpha;
      }
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        const float4 v4 = ld4(vb + s * PLD + pidx<D>(c0));
        float p[G];
        if constexpr (G % 4 == 0) {
#pragma unroll
          for (int r = 0; r < G; r += 4) {
            const float4 p4 = ld4(pb + s * G + r);
            p[r] = p4.x; p[r + 1] = p4.y; p[r + 2] = p4.z; p[r + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < G; ++r) p[r] = pb[s * G + r];
        }
#pragma unroll
        for (int r = 0; r < G; ++r) {
          acc[r][0] += p[r] * v4.x;
          acc[r][1] += p[r] * v4.y;
          acc[r][2] += p[r] * v4.z;
          acc[r][3] += p[r] * v4.w;
        }
      }
    }
    __syncwarp();  // the tiles are rewritten by the next block
    cur = nxt;
  }

  // merge the warps' states in warp order into the CTA's partial
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1) l_r[j] += __shfl_xor_sync(0xffffffffu, l_r[j], o);
  __syncthreads();                 // every warp is done with its tiles
  float* aw = vbuf;                // [WARPS][G][D]
  float* mw = pbuf;                // [WARPS][2][G]: m, l; then [WARPS][G] weights
  float* wt = pbuf + 2 * WARPS * G;
  if (owns_c) {
#pragma unroll
    for (int r = 0; r < G; ++r)
      *reinterpret_cast<float4*>(aw + (warp * G + r) * D + c0) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  if (lane < LPS && owner) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      mw[warp * 2 * G + rbase + j] = m_r[j];
      mw[(warp * 2 + 1) * G + rbase + j] = l_r[j];
    }
  }
  __syncthreads();
  // partials laid out (b, h, nsplit, ...): head kvh * G + r of slot b
  if (tid < G) {
    const int r = tid;
    float m_all = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m_all = fmaxf(m_all, mw[w * 2 * G + r]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      wt[w * G + r] = expf(mw[w * 2 * G + r] - m_all);
      l += mw[(w * 2 + 1) * G + r] * wt[w * G + r];
    }
    const size_t pi = ((size_t)b * h + kvh * G + r) * nsplit + split;
    m_part[pi] = m_all;
    l_part[pi] = l;
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += THREADS) {
    const int r = e / D, c = e % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += aw[(w * G + r) * D + c] * wt[w * G + r];
    acc_part[(((size_t)b * h + kvh * G + r) * nsplit + split) * D + c] = a;
  }
}

// One CTA of D threads (at least a warp) per (slot, head): merge the partials in split order
// (segment-then-split).  The splits' m and l are staged in shared memory
// once; each thread's partial loads are independent, so many are in flight.
// Writes acc (f32, unnormalized) and / or out (acc / l in q's dtype), m, l.
template <int D>
__global__ void __launch_bounds__(D < 32 ? 32 : D)
merge_kernel(const float* __restrict__ acc_part, const float* __restrict__ m_part,
             const float* __restrict__ l_part, float* __restrict__ acc_out,
             void* __restrict__ out, int out_bf16, float* __restrict__ m_out,
             float* __restrict__ l_out, int nsplit) {
  constexpr int PF = 32;          // partials each thread loads before the first sync
  extern __shared__ float ml[];  // [2][nsplit]: m, then the weights; l; then m_all, l_all
  const size_t bh = blockIdx.x;
  const int c = threadIdx.x;  // a channel, below D (a block has at least one full warp)
  const bool has_c = c < D;
  const float* ap = acc_part + bh * nsplit * D + c;
  float av[PF];
#pragma unroll
  for (int i = 0; i < PF; ++i) av[i] = has_c && i < nsplit ? __ldg(ap + (size_t)i * D) : 0.f;
  for (int i = c; i < nsplit; i += blockDim.x) {
    ml[i] = __ldg(m_part + bh * nsplit + i);
    ml[nsplit + i] = __ldg(l_part + bh * nsplit + i);
  }
  __syncthreads();
  if (c < 32) {  // one warp: the weights exp(m_i - m_all) and l_all, in split order
    float m_all = NEG_INF;
    for (int i = c; i < nsplit; i += 32) m_all = fmaxf(m_all, ml[i]);
#pragma unroll
    for (int o = 16; o; o >>= 1) m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, o));
    float l = 0.f;
    for (int i = c; i < nsplit; i += 32) {
      const float w = expf(ml[i] - m_all);
      ml[i] = w;
      l += ml[nsplit + i] * w;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (c == 0) {
      ml[2 * nsplit] = m_all;
      ml[2 * nsplit + 1] = l;
    }
  }
  __syncthreads();
  const float* w = ml;
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < PF; ++i)
    if (i < nsplit) a += av[i] * w[i];
  if (!has_c) return;
#pragma unroll 16
  for (int i = PF; i < nsplit; ++i) a += __ldg(ap + (size_t)i * D) * w[i];
  const float m_all = ml[2 * nsplit], l = ml[2 * nsplit + 1];
  if (acc_out != nullptr) acc_out[bh * D + c] = a;
  if (out != nullptr) {
    const float o = a / fmaxf(l, 1e-30f);
    if (out_bf16) static_cast<__nv_bfloat16*>(out)[bh * D + c] = __float2bfloat16_rn(o);
    else static_cast<float*>(out)[bh * D + c] = o;
  }
  if (c == 0) {
    m_out[bh] = m_all;
    l_out[bh] = l;
  }
}

struct Launch {
  const void* q;
  void *acc_part, *m_part, *l_part, *acc, *out, *m, *l, *p, *mrun;
  int b, h, hk, q_bf16;
  float scale;
  int bpc, nsplit;
  cudaStream_t stream;
};

template <bool PAGED, int D, int G>
cudaError_t launch(const Layer& L, const Launch& a) {
  constexpr size_t smem = smem_bytes(D, G);
  static_assert(smem <= 48 * 1024, "no opt-in to more dynamic shared memory");
  dim3 grid(a.hk, a.b, a.nsplit);
  split_kernel<PAGED, D, G><<<grid, THREADS, smem, a.stream>>>(
      a.q, a.q_bf16, L, static_cast<float*>(a.acc_part), static_cast<float*>(a.m_part),
      static_cast<float*>(a.l_part), static_cast<float*>(a.p), static_cast<float*>(a.mrun),
      a.h, a.hk, a.scale, a.bpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<D><<<a.b * a.h, D < 32 ? 32 : D, (2 * a.nsplit + 2) * sizeof(float), a.stream>>>(
      static_cast<const float*>(a.acc_part), static_cast<const float*>(a.m_part),
      static_cast<const float*>(a.l_part), static_cast<float*>(a.acc), a.out, a.q_bf16,
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.nsplit);
  return cudaGetLastError();
}

template <bool PAGED, int D>
cudaError_t launch_g(int g, const Layer& L, const Launch& a) {
  switch (g) {
    case 1: return launch<PAGED, D, 1>(L, a);
    case 2: return launch<PAGED, D, 2>(L, a);
    case 3: return launch<PAGED, D, 3>(L, a);
    case 4: return launch<PAGED, D, 4>(L, a);
    case 7: return launch<PAGED, D, 7>(L, a);
    case 8: return launch<PAGED, D, 8>(L, a);
    default: return cudaErrorInvalidValue;
  }
}

inline int fmt_of(int bits, int t_bf16) { return bits >= 16 ? (t_bf16 ? 16 : 32) : bits; }

// The host half of both C entry points.  q (b,h,d) in bf16 or f32 (q_bf16)
// | segs: n_seg (1..3) host SegDesc records, in walk order | scratch
// acc_part (b,h,nsplit,d), m_part / l_part (b,h,nsplit) f32: nsplit CTAs
// per (slot, kv head), each walking bpc blocks of 32 slots, nsplit * bpc >=
// the walk's blocks (counted per segment), nsplit <= 4096 | outputs: acc
// (b,h,d) f32 and / or out (b,h,d) in q's dtype (either may be null), m
// (b,h), l (b,h) f32; p and mrun (b,h,sum s_seg) f32, or both null to skip
// them.  The group size h / hk is 1, 2, 3, 4, 7 or 8; d is 16, 32, 64 or 128.
template <bool PAGED>
int walk_launch(const void* q, const void* segs, int n_seg, void* acc_part, void* m_part,
                void* l_part, void* acc, void* out, void* m, void* l, void* p, void* mrun, int b,
                int h, int hk, int d, float scale, int bpc, int nsplit, int q_bf16,
                void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || hk <= 0 || h % hk || n_seg < 1 || n_seg > MAX_SEGS || bpc <= 0 ||
      nsplit <= 0 || nsplit > MAX_SPLITS || ((p == nullptr) != (mrun == nullptr)) ||
      (acc == nullptr && out == nullptr))
    return bad;
  Layer L{};
  int blk = 0, slot = 0;
  for (int i = 0; i < n_seg; ++i) {
    const SegDesc& sd = static_cast<const SegDesc*>(segs)[i];
    const bool raw = sd.k_bits >= 16;
    auto bits_ok = [](int bits) { return bits == 2 || bits == 4 || bits == 8; };
    const bool paging_ok = !PAGED || (sd.page > 0 && sd.npp > 0 && sd.table &&
                                      (long long)sd.npp * sd.page >= sd.s_seg);
    if (!paging_ok || sd.s_seg <= 0 || !sd.kpool || !sd.vpool || !sd.pos ||
        raw != (sd.v_bits >= 16) ||
        (!raw && (!bits_ok(sd.k_bits) || !bits_ok(sd.v_bits) || !sd.ks || !sd.kz || !sd.vcs ||
                  !sd.vts || !sd.vtz)))
      return bad;
    L.seg[i] = Seg{sd, fmt_of(sd.k_bits, sd.t_bf16), fmt_of(sd.v_bits, sd.t_bf16), blk, slot};
    blk += (sd.s_seg + BS - 1) / BS;
    slot += sd.s_seg;
  }
  L.n_seg = n_seg;
  L.n_blk = blk;
  L.s_total = slot;
  if ((long long)nsplit * bpc < blk) return bad;
  const Launch a{q, acc_part, m_part, l_part, acc, out, m, l, p, mrun,
                 b, h, hk, q_bf16, scale, bpc, nsplit, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (d) {
    case 16: err = launch_g<PAGED, 16>(h / hk, L, a); break;
    case 32: err = launch_g<PAGED, 32>(h / hk, L, a); break;
    case 64: err = launch_g<PAGED, 64>(h / hk, L, a); break;
    case 128: err = launch_g<PAGED, 128>(h / hk, L, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace qattn_walk
