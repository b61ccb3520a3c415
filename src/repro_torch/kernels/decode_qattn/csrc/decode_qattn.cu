// One-token GQA decode attention over the MIXED ZipCache cache of one
// decode layer, sm_90a: the 4-bit hi store, the 2-bit lo store and the raw
// bf16 staging window in one split kernel and one ordered merge kernel.
//
// Replaces src/repro/kernels/decode_qattn/kernel.py::qattn_segment (body
// _qattn_kernel), which the reference calls once per store before it runs
// the window in jnp and merges the three segments' flash stats
// (ops.decode_attend_mixed).  Here a store call is the one-segment case of
// the layer kernel.  Each segment is one contiguous (b, hk, S, c) tensor
// (int8 codes, or raw values for the window and raw >= 16-bit stores) with
// dense per-slot parameters; slots with pos < 0 (the window's win_pos) are
// masked.
//
// The walk (design, bound, numerics) is the contiguous instantiation of
// ../../csrc/qattn_walk.cuh, which paged_qattn.cu shares with its page
// table lookup: here the token row is (b * hk + h) * S + slot, so each slot
// costs one dependent load fewer.
#include "../../csrc/qattn_walk.cuh"

extern "C" const char* zc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Operands as qattn_walk::walk_launch describes them; each SegDesc's table,
// npp and page are unused, and its payload holds s_seg slots per (b, kv head).
extern "C" int decode_qattn_launch(const void* q, const void* segs, int n_seg, void* acc_part,
                                   void* m_part, void* l_part, void* acc, void* out, void* m,
                                   void* l, void* p, void* mrun, int b, int h, int hk, int d,
                                   float scale, int bpc, int nsplit, int q_bf16, void* stream) {
  return qattn_walk::walk_launch<false>(q, segs, n_seg, acc_part, m_part, l_part, acc, out, m,
                                        l, p, mrun, b, h, hk, d, scale, bpc, nsplit, q_bf16,
                                        stream);
}
