// An alternative to the scratch pass of the chunk and quad products: the
// pieces of a split panel combined through thread-block clusters and
// distributed shared memory, so that their partial panels never leave the
// chip.  Built and timed against the products' own route by
// tools/time_cluster_combine.py; nothing in nmf_tpu_torch uses it.
//
// A launch is clusters of C blocks.  Each block walks one piece (or none:
// padding) with piece_walk.cuh's walk_piece, then the blocks of one group
// (the pieces of one panel, or C of them for a panel of more than C pieces)
// each add a share of the panel's rows across the group's panels in rank
// order, reading the others' shared memory, and write it to the output (or,
// for a panel of more than C pieces, to a partial panel in scratch that
// piece_walk's combine_kernel adds in order).  A group of one block writes
// its own panel, as piece_kernel does.  The sums are those of the scratch
// route: (p0 + p1) + p2 ..., then added to the output where it accumulates.

#include <cooperative_groups.h>

#include "chunk_matmul.cu"
#include "quad_matmul.cu"

namespace cg = cooperative_groups;

// bgroup[b] = (rank of the group's first block) << 8 | (blocks in the group);
// bdst[b] = the group's partial panel in parts, or -1 to write the output.
template <class Store, int V>
__global__ void __launch_bounds__(WARPS * 32)
cluster_kernel(Store st, const int* __restrict__ piece_ptr,
               const int* __restrict__ piece_panel,
               const int* __restrict__ items, const int* __restrict__ bpiece,
               const int* __restrict__ bgroup, const int* __restrict__ bdst,
               const float* __restrict__ D, float* __restrict__ out,
               float* __restrict__ parts, int rows, int k, int accumulate) {
  using Vt = piece_walk::Vec<V>;
  using T = typename Vt::T;
  extern __shared__ float acc[];  // TILE x k, row-major
  cg::cluster_group cl = cg::this_cluster();
  const int p = bpiece[blockIdx.x];
  if (p >= 0)
    piece_walk::walk_piece<Store, V>(st, piece_ptr[p], piece_ptr[p + 1],
                                     items, D, acc, k);
  cl.sync();
  if (p >= 0) {
    const int g0 = bgroup[blockIdx.x] >> 8, gn = bgroup[blockIdx.x] & 255;
    const int i = (int)cl.block_rank() - g0;
    const int panel = piece_panel[p], dst = bdst[blockIdx.x];
    const int valid = dst >= 0 ? TILE : min(TILE, rows - panel * TILE);
    const int r0 = i * TILE / gn, r1 = min((i + 1) * TILE / gn, valid);
    float* d0 = dst >= 0 ? parts + (size_t)dst * TILE * k
                         : out + (size_t)panel * TILE * k;
    const bool add = dst < 0 && accumulate;
    const int kv = k / V;
    for (int j = (threadIdx.x >> 5) * 32 * V + V * (threadIdx.x & 31); j < k;
         j += WARPS * 32 * V) {
      T* d = reinterpret_cast<T*>(d0 + j);
      for (int ra = r0; ra < r1; ra += 8) {
        T s[8], o[8];
        const T* a = reinterpret_cast<const T*>(cl.map_shared_rank(acc, g0) + j);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          s[u] = ra + u < r1 ? a[(ra + u) * kv] : Vt::zero();
          o[u] = add && ra + u < r1 ? d[(ra + u) * kv] : Vt::zero();
        }
        for (int q = 1; q < gn; ++q) {
          a = reinterpret_cast<const T*>(cl.map_shared_rank(acc, g0 + q) + j);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (ra + u < r1) s[u] = Vt::sum(s[u], a[(ra + u) * kv]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (ra + u < r1) d[(ra + u) * kv] = add ? Vt::sum(o[u], s[u]) : s[u];
      }
    }
  }
  cl.sync();  // no block leaves while another reads its panel
}

template <class Store, int V>
static int launch_cluster(Store st, const int* piece_ptr,
                          const int* piece_panel, const int* items,
                          const int* bpiece, const int* bgroup,
                          const int* bdst, const float* D, float* out,
                          float* parts, int n_blocks, int C, int rows, int k,
                          int accumulate, cudaStream_t stream) {
  auto kern = cluster_kernel<Store, V>;
  const size_t smem = (size_t)TILE * k * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!e && C > 8)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, st, piece_ptr, piece_panel, items, bpiece,
                         bgroup, bdst, D, out, parts, rows, k, accumulate);
  return e ? (int)e : (int)cudaGetLastError();
}

template <class Store>
static int launch_any(Store st, const int* piece_ptr, const int* piece_panel,
                      const int* items, const int* bpiece, const int* bgroup,
                      const int* bdst, const float* D, float* out, float* parts,
                      int n_blocks, int C, int rows, int k, int accumulate,
                      void* stream) {
  if (n_blocks == 0) return 0;
  return k % 2 == 0
             ? launch_cluster<Store, 2>(st, piece_ptr, piece_panel, items,
                                        bpiece, bgroup, bdst, D, out, parts,
                                        n_blocks, C, rows, k, accumulate,
                                        (cudaStream_t)stream)
             : launch_cluster<Store, 1>(st, piece_ptr, piece_panel, items,
                                        bpiece, bgroup, bdst, D, out, parts,
                                        n_blocks, C, rows, k, accumulate,
                                        (cudaStream_t)stream);
}

extern "C" int x_chunk_cluster(const int* piece_ptr, const int* piece_panel,
                               const int* panel_chunks, const int* chunk_nreal,
                               const int* win_panel, const int* coords,
                               const float* vals, const int* bpiece,
                               const int* bgroup, const int* bdst,
                               const float* D, float* out, float* parts,
                               int n_blocks, int C, int group, int span,
                               int rows, int k, void* stream) {
  const ChunkItems st{chunk_nreal, win_panel, coords, vals, group, span};
  return launch_any(st, piece_ptr, piece_panel, panel_chunks, bpiece, bgroup,
                    bdst, D, out, parts, n_blocks, C, rows, k, 0, stream);
}

extern "C" int x_quad_cluster(const int* qpiece_ptr, const int* qpiece_panel,
                              const int* qpanel_segs, const int* qseg_nreal,
                              const int* qwin_panel, const int* qlrows,
                              const int* qlcols, const float* qvals,
                              const int* bpiece, const int* bgroup,
                              const int* bdst, const float* D, float* out,
                              float* parts, int n_blocks, int C, int qgroup,
                              int seg, int rows, int k, void* stream) {
  const QuadItems st{qseg_nreal, qwin_panel, qlrows, qlcols, qvals, qgroup, seg};
  return launch_any(st, qpiece_ptr, qpiece_panel, qpanel_segs, bpiece, bgroup,
                    bdst, D, out, parts, n_blocks, C, rows, k, 1, stream);
}

// The products' own second pass alone, over n_split panels' partials.
extern "C" int x_combine(const int* split_ptr, const int* split_panel,
                         const float* parts, float* out, int n_split, int rows,
                         int k, int accumulate, void* stream) {
  if (n_split == 0) return 0;
  const int per = (TILE * k + 1023) / 1024;
  piece_walk::combine_kernel<<<dim3(n_split, per), 256, 0, (cudaStream_t)stream>>>(
      split_ptr, split_panel, parts, out, rows, k, accumulate);
  return (int)cudaGetLastError();
}
