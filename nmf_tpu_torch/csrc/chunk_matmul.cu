// Narrow-chunk sparse-dense product:  out = X_chunks @ D.
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_kernel_compact
// (launched by _tiled_matmul_compact_impl).  Per 128-slot chunk it gathers
// the row of D at each slot's column, scales it by the slot's value and adds
// it into the slot's row of the chunk's 128-row output panel.
//
// What bounds it on an H100: bytes.  Each stored nonzero costs 8 bytes of
// store plus one gathered row of D (k floats, 512 contiguous bytes at
// k = 128) for 2k flops, far below the card's flops-per-byte ratio.  D is
// read again for every nonzero of a column, so the gathers mostly hit the
// 50 MB L2, and the floor is the store, D and the output moved once each.
//
// Design: the walk of piece_walk.cuh over the chunks of each piece of a row
// panel's chunk list (the pieces are built once per store on the host, by
// ops/sparse_format.py:row_panel_index).  A chunk's entries are its first
// chunk_nreal slots, each ``lcol << 7 | lrow``; a chunk tile may span several
// col panels (wide tail tiles), so a slot's local column runs to span * 128
// and the window's panel counts wide panels: the gathered row is one index
// either way.  Every row of the output is written: a panel without chunks
// keeps one empty piece, which writes zeros.

#include "piece_walk.cuh"

struct ChunkItems {
  const int* nreal;
  const int* win_panel;
  const int* coords;
  const float* vals;
  int group, span;

  // loads only: what they read is used a batch later
  __device__ __forceinline__ void item(int id, int& n, long long& first,
                                       int& cpanel) const {
    n = nreal[id];
    first = (long long)id * TILE;
    cpanel = win_panel[id / group];
  }
  __device__ __forceinline__ void slot(long long s, int cpanel, int& row,
                                       int& drow, float& v) const {
    const int c = coords[s];
    v = vals[s];
    row = c & (TILE - 1);
    drow = cpanel * span * TILE + (c >> 7);
  }
};

// out (rows x k) = chunk store @ D (cols x k); every row of out is written.
// parts holds the partial panels of the split panels (n_parts x 128 x k).
// Returns the CUDA error code of the launches (0 = success).
extern "C" int nmf_chunk_matmul(const int* piece_ptr, const int* piece_panel,
                                const int* piece_part, const int* split_ptr,
                                const int* split_panel, const int* panel_chunks,
                                const int* chunk_nreal, const int* win_panel,
                                const int* coords, const float* vals,
                                const float* D, float* out, float* parts,
                                int n_pieces, int n_split, int group, int span,
                                int rows, int k, void* stream) {
  const ChunkItems st{chunk_nreal, win_panel, coords, vals, group, span};
  return piece_walk::launch(st, piece_ptr, piece_panel, piece_part, split_ptr,
                            split_panel, panel_chunks, D, out, parts, n_pieces,
                            n_split, rows, k, 0, (cudaStream_t)stream);
}
