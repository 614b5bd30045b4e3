// Sampled product over the quad store:  out[slot] = (W @ H)[row(slot), col(slot)].
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_sddmm_quad_kernel
// (launched by _tiled_sddmm_quad_impl).  A quad chunk holds 128 / seg small
// tiles of one (stripe, col panel), each in its own run of seg slots (a
// sub-segment, seg = 32 or 16) with its own row panel; a slot stores its row
// and its column inside the tile.  The value wanted at a slot is the dot
// product of one row of W and one column of H.
//
// What bounds it and the design: sddmm_piece.cuh, whose walk over the
// store's pieces this kernel shares with the chunk store's
// (chunk_sddmm.cu).  Here an item is a sub-segment of seg slots, its
// entries at its front (qseg_nreal); the pieces are those of the quad
// sub-segments (qpiece_*, over qpanel_segs), which kernel 3 walks, so all
// sub-segments of a piece feed one row panel of W, which the block stages
// once.  About 94 % of the ttt4 quad store's slots are padding: the block
// reads the coordinates of the real slots only (qlrows, qlcols, qinv) and
// writes 0 at the rest, and the sub-segments nothing was packed into are
// zeroed by the blocks past the pieces.  A sub-segment's column panel is
// its chunk's window's: qwin_panel[chunk / qgroup].  Any k >= 1.

#include "sddmm_piece.cuh"

// out (n_qchunks * 128) = (W @ Ht') at every stored slot of the quad store,
// 0 at padding slots.  W is (rows x k), Ht is (cols x k), both row-major;
// seg is 32 or 16; the pieces (qpiece_ptr, qpiece_panel over qpanel_segs)
// and qseg_nreal come from the store's row-panel index; ``g`` lanes sample
// a slot (a power of two up to 32).  Returns the CUDA error code of the
// launch (0 = success).
extern "C" int nmf_quad_sddmm(const int* qpiece_ptr, const int* qpiece_panel,
                              const int* qpanel_segs, const int* qseg_nreal,
                              const int* qwin_panel, const int* qlrows,
                              const int* qlcols, const int* qinv, const float* W,
                              const float* Ht, float* out, int n_pieces,
                              int n_qchunks, int qgroup, int seg, int rows,
                              int cols, int k, int nnz, int g, void* stream) {
  if (seg != 32 && seg != 16) return (int)cudaErrorInvalidValue;
  if (n_qchunks > INT_MAX / TILE) return (int)cudaErrorInvalidValue;
  const sddmm_piece::SplitCoords st{qlcols, qlrows};
  const int n_segs = n_qchunks * (TILE / seg);
  return seg == 32
      ? sddmm_piece::launch<sddmm_piece::SplitCoords, 5>(
            qpiece_ptr, qpiece_panel, qpanel_segs, qseg_nreal, qwin_panel, st,
            qinv, W, Ht, out, n_pieces, n_segs, qgroup, 1, rows, cols, k, nnz,
            g, (cudaStream_t)stream)
      : sddmm_piece::launch<sddmm_piece::SplitCoords, 4>(
            qpiece_ptr, qpiece_panel, qpanel_segs, qseg_nreal, qwin_panel, st,
            qinv, W, Ht, out, n_pieces, n_segs, qgroup, 1, rows, cols, k, nnz,
            g, (cudaStream_t)stream);
}
