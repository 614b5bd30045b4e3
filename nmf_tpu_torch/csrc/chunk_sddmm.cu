// Sampled product over the chunk store:  out[slot] = (W @ H)[row(slot), col(slot)].
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_sddmm_kernel_compact
// (launched by _tiled_sddmm_compact_impl).  Every 128-slot chunk holds local
// coordinates ``lcol << 7 | lrow`` inside one (row panel, col panel) tile; the
// value wanted at a slot is the dot product of one row of W and one column
// of H.
//
// What bounds it and the design: sddmm_piece.cuh, whose walk over the
// store's pieces this kernel shares with the quad store's (quad_sddmm.cu).
// Here an item is a chunk of 128 slots, its entries at its front
// (chunk_nreal); a chunk tile may span ``span`` col panels.

#include "sddmm_piece.cuh"

// out (n_chunks * 128) = (W @ Ht') at every stored slot of the chunk store,
// 0 at padding slots.  W is (rows x k), Ht is (cols x k), both row-major; the
// store's pieces (piece_ptr, piece_panel over panel_chunks) and chunk_nreal
// come from its row-panel index; ``g`` lanes sample a slot (a power of two
// up to 32).  Returns the CUDA error code of the launch (0 = success).
extern "C" int nmf_chunk_sddmm(const int* piece_ptr, const int* piece_panel,
                               const int* panel_chunks, const int* chunk_nreal,
                               const int* win_panel, const int* coords,
                               const int* inv, const float* W, const float* Ht,
                               float* out, int n_pieces, int n_chunks, int group,
                               int span, int rows, int cols, int k, int nnz,
                               int g, void* stream) {
  return sddmm_piece::launch<sddmm_piece::PackedCoords, 7>(
      piece_ptr, piece_panel, panel_chunks, chunk_nreal, win_panel,
      sddmm_piece::PackedCoords{coords}, inv, W, Ht, out, n_pieces, n_chunks,
      group, span, rows, cols, k, nnz, g, (cudaStream_t)stream);
}
