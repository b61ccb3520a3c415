// CSTQuant (paper Alg. 1) for Hopper, sm_90a.
//
// Replaces src/repro/kernels/cst_quant/kernel.py::cst_quantize_pallas (body
// _cst_quant_kernel).  Per token row: xn = x / c; per-token min/max ->
// scale = max((max - min) / qmax, 1e-8), zero = round(-min / scale);
// codes = clip(round(xn / scale + zero), 0, qmax), packed 8/bits fields
// LSB-first into one byte.
//
// Bound on the H100: bytes.  Each element is read once (2 bytes in bf16) and
// leaves as bits/8 bytes, with a few float operations in between.  Design:
// one warp per token row; a shuffle reduction gives min/max, then each lane
// packs whole bytes in registers and stores them, so x is read twice (the
// second read hits L1/L2) and codes are written once.  The arithmetic is
// IEEE division and round-half-to-even (rintf), the reference's, so the
// codes are bit-identical; never build this file with --use_fast_math.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int BITS>
__global__ void cst_quant_kernel(const T* __restrict__ x, const float* __restrict__ c,
                                 int8_t* __restrict__ codes, float* __restrict__ scale_out,
                                 float* __restrict__ zero_out, int rows, int rows_per_slice,
                                 int C) {
  constexpr int PF = 8 / BITS;
  constexpr float QMAX = float((1 << BITS) - 1);
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + (size_t)row * C;
  const float* cr = c + (size_t)(row / rows_per_slice) * C;

  float mn = INFINITY, mx = -INFINITY;
  for (int j = lane; j < C; j += 32) {
    const float v = to_f32(xr[j]) / cr[j];
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const float scale = fmaxf((mx - mn) / QMAX, 1e-8f);
  const float zero = rintf(-mn / scale);

  const int nbytes = C / PF;
  int8_t* out = codes + (size_t)row * nbytes;
  for (int byte = lane; byte < nbytes; byte += 32) {
    unsigned word = 0;
#pragma unroll
    for (int f = 0; f < PF; ++f) {
      const int j = byte * PF + f;
      const float xn = to_f32(xr[j]) / cr[j];
      const float q = fminf(fmaxf(rintf(xn / scale + zero), 0.f), QMAX);
      word |= static_cast<unsigned>(q) << (BITS * f);
    }
    out[byte] = static_cast<int8_t>(static_cast<uint8_t>(word));
  }
  if (lane == 0) {
    scale_out[row] = scale;
    zero_out[row] = zero;
  }
}

template <typename T>
void launch(const void* x, const void* c, void* codes, void* scale, void* zero, int rows,
            int rows_per_slice, int C, int bits, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (rows * 32 + threads - 1) / threads;
  auto* xp = static_cast<const T*>(x);
  auto* cp = static_cast<const float*>(c);
  auto* op = static_cast<int8_t*>(codes);
  auto* sp = static_cast<float*>(scale);
  auto* zp = static_cast<float*>(zero);
  if (bits == 4)
    cst_quant_kernel<T, 4><<<blocks, threads, 0, stream>>>(xp, cp, op, sp, zp, rows, rows_per_slice, C);
  else
    cst_quant_kernel<T, 2><<<blocks, threads, 0, stream>>>(xp, cp, op, sp, zp, rows, rows_per_slice, C);
}

}  // namespace

extern "C" const char* zc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (rows, C) bf16 or f32, rows = slices * rows_per_slice; c: (slices, C) f32.
// Outputs: codes (rows, C / (8 / bits)) int8, scale and zero (rows,) f32.
extern "C" int cst_quant_launch(const void* x, const void* c, void* codes, void* scale,
                                void* zero, int rows, int rows_per_slice, int C, int bits,
                                int x_is_bf16, void* stream) {
  if ((bits != 2 && bits != 4) || C % (8 / bits) || rows_per_slice <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    launch<__nv_bfloat16>(x, c, codes, scale, zero, rows, rows_per_slice, C, bits, s);
  else
    launch<float>(x, c, codes, scale, zero, rows, rows_per_slice, C, bits, s);
  return static_cast<int>(cudaGetLastError());
}
