// Quad-tail sparse-dense product:  out += X_quad @ D.
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_quad_kernel
// (launched by _tiled_quad_impl).  Tiles with few nonzeros share a 128-slot
// chunk: 128 / seg tiles of one (stripe, col panel), each in its own run of
// seg slots (a sub-segment, seg = 32 or 16) with its own row panel.  Per
// slot the kernel gathers the row of D at the slot's column, scales it by
// the slot's value and adds it into the slot's row of the sub-segment's
// 128-row output panel.
//
// What bounds it on an H100: bytes.  A stored nonzero costs 12 bytes of
// store plus one gathered row of D (k floats) for 2k flops.  D is read again
// for every nonzero of a column, mostly from the 50 MB L2, and the floor is
// the store, D and the output moved once each.
//
// Design: the walk of piece_walk.cuh over the sub-segments of each piece of
// a row panel's sub-segment list (the store's row-panel index over
// sub-segments leaves out those nothing was packed into).  A sub-segment
// holds about 5 entries on the ttt4 quad store, so a round packs the entries
// of many sub-segments, and of several chunks, into 32.  The sub-segments of
// one chunk feed different panels, so a chunk is read by up to 128 / seg
// blocks, each reading only its own slots.  The panel is added to the output
// (read-add-write); a panel without any sub-segment has no piece and leaves
// its rows of the output untouched.

#include "piece_walk.cuh"

struct QuadItems {
  const int* nreal;
  const int* qwin_panel;
  const int* qlrows;
  const int* qlcols;
  const float* qvals;
  int qgroup, seg;

  // loads only: what they read is used a batch later
  __device__ __forceinline__ void item(int sg, int& n, long long& first,
                                       int& cpanel) const {
    const int nper = TILE / seg;
    const int chunk = sg / nper;
    n = nreal[sg];
    first = (long long)chunk * TILE + (sg - chunk * nper) * seg;
    cpanel = qwin_panel[chunk / qgroup];
  }
  __device__ __forceinline__ void slot(long long s, int cpanel, int& row,
                                       int& drow, float& v) const {
    v = qvals[s];
    row = qlrows[s];
    drow = cpanel * TILE + qlcols[s];
  }
};

// out (rows x k) += quad store @ D (cols x k); seg is 32 or 16.  parts holds
// the partial panels of the split panels (n_parts x 128 x k).
// Returns the CUDA error code of the launches (0 = success).
extern "C" int nmf_quad_matmul(const int* qpiece_ptr, const int* qpiece_panel,
                               const int* qpiece_part, const int* qsplit_ptr,
                               const int* qsplit_panel, const int* qpanel_segs,
                               const int* qseg_nreal, const int* qwin_panel,
                               const int* qlrows, const int* qlcols,
                               const float* qvals, const float* D, float* out,
                               float* parts, int n_pieces, int n_split,
                               int qgroup, int seg, int rows, int k,
                               void* stream) {
  if (seg != 32 && seg != 16) return (int)cudaErrorInvalidValue;
  const QuadItems st{qseg_nreal, qwin_panel, qlrows, qlcols, qvals, qgroup, seg};
  return piece_walk::launch(st, qpiece_ptr, qpiece_panel, qpiece_part,
                            qsplit_ptr, qsplit_panel, qpanel_segs, D, out,
                            parts, n_pieces, n_split, rows, k, 1,
                            (cudaStream_t)stream);
}
