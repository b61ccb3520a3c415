// One-token GQA decode attention over the PAGED ZipCache stores of one
// decode layer, sm_90a: up to three segments (4-bit hi, 2-bit lo, raw bf16
// staging window) in one split kernel and one ordered merge kernel.
//
// Replaces src/repro/kernels/paged_qattn/kernel.py::qattn_paged_segment
// (body _paged_qattn_kernel); the reference calls it once per segment and
// merges the segments' flash stats in jnp (ops.attend_paged).  Here a
// segment call is the one-segment case of the layer kernel.  The payload
// lives in page pools (P, hk, page, c) addressed through a (b, npp) page
// table; the small per-slot parameters stay dense.  The TPU kernel took the
// table as a scalar-prefetch operand and let each grid step's index map
// pick the page; here each lane loads table[b, slot / page] itself and
// forms the token row of the pool.  NULL entries of the free-list layout
// point at the sink page; their slots carry pos < 0 and are masked.
//
// The walk (design, bound, numerics) is the paged instantiation of
// ../../csrc/qattn_walk.cuh, which decode_qattn.cu shares with the
// contiguous addressing of the mixed cache.
#include "../../csrc/qattn_walk.cuh"

extern "C" const char* zc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Operands as qattn_walk::walk_launch describes them; each SegDesc names its
// page table (b, npp) and page size, with s_seg <= npp * page.
extern "C" int paged_qattn_launch(const void* q, const void* segs, int n_seg, void* acc_part,
                                  void* m_part, void* l_part, void* acc, void* out, void* m,
                                  void* l, void* p, void* mrun, int b, int h, int hk, int d,
                                  float scale, int bpc, int nsplit, int q_bf16, void* stream) {
  return qattn_walk::walk_launch<true>(q, segs, n_seg, acc_part, m_part, l_part, acc, out, m, l,
                                       p, mrun, b, h, hk, d, scale, bpc, nsplit, q_bf16, stream);
}
