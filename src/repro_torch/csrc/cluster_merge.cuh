// The split merge of the port's decode-shaped attention bodies, in one
// launch: the blocks that split the slots of one (b, kv group) form a
// thread block cluster and merge their partial (acc, m, l) through
// distributed shared memory (DSMEM), in a fixed rank order. Shared by the
// one-token decode bodies (decode_attention.cuh: kernels 1 and 3) and the
// multi-query bodies (mq_decode_attention.cuh: kernels 4 and 5), with the
// asynchronous-copy and ldmatrix helpers their K/V rings use.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

namespace cg = cooperative_groups;

constexpr int CLUSTER_MAX = 8;   // splits of one (b, kv group): a cluster's blocks

// barrier.cluster halves. Every kernel arrives (relaxed) as it starts and
// waits before its first store to a peer: DSMEM of a block may be written
// only once that block runs.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Floats of the region in which a block receives its peers' partials:
// rA, rows of DHP + 4 floats (the stride keeps stores of column pairs free
// of bank conflicts) for up to GM + CLUSTER_MAX - 1 rows (n·ceil(G / n)),
// then rM, rL and the merge's coefficients rC per rank and row, and rS.
template <int GM, int DHP>
constexpr int merge_floats() {
  return (GM + CLUSTER_MAX - 1) * (DHP + 4) + 3 * CLUSTER_MAX * GM + GM;
}

// The cluster's merge, by pushes. The outputs are G rows of dh (a head of
// one-token decode, or a query row of the multi-query kernels). Block
// `rank` of the n blocks of a cluster owns rows [rank·rpo, (rank + 1)·rpo),
// rpo = ceil(G / n). Every block pushes its split's partial of each row
// (acc, unnormalized, and (m, l)) into the row's slot in its owner's
// receive region (stores to distributed shared memory: no round trip);
// after one cluster barrier each owner merges its rows over the splits in
// rank order from its own shared memory: M = max m, c = exp(m - M) and
// L = sum l·c once per (split, row), then each element A = sum acc·c and
// A / L. The order is fixed, so the result is deterministic and the same
// for every Addr policy. The grid's x dimension is the split:
// n = gridDim.x.
template <int GM, int DHP>
struct ClusterMerge {
  static constexpr int RST = DHP + 4;
  float* rA;  // [n][rpo][RST]
  float* rM;  // [n][GM]
  float* rL;  // [n][GM]
  float* rC;  // [n][GM]: exp(m - M) of each split for the rows owned here
  float* rS;  // [GM]: L of the rows owned here
  int n, rank, rpo, G, dh;

  __device__ __forceinline__ ClusterMerge(float* region, int G_, int dh_)
      : rA(region), rM(region + (GM + CLUSTER_MAX - 1) * RST), rL(rM + CLUSTER_MAX * GM),
        rC(rL + CLUSTER_MAX * GM), rS(rC + CLUSTER_MAX * GM), n((int)gridDim.x),
        rank((int)blockIdx.x), rpo((G_ + (int)gridDim.x - 1) / (int)gridDim.x), G(G_),
        dh(dh_) {}

  // this block's slot for row g (g < G) in the owner's shared memory
  __device__ __forceinline__ float* row_at(int g) const {
    const int o = g / rpo;
    return cg::this_cluster().map_shared_rank(rA + (rank * rpo + g - o * rpo) * RST, o);
  }
  __device__ __forceinline__ void push_acc(int g, int d, float a) const {
    if (g >= G || d >= dh) return;
    row_at(g)[d] = a;
  }
  // (m, l) of row g, to its owner
  __device__ __forceinline__ void push_ml(int g, float m, float l) const {
    if (g >= G) return;
    const int o = g / rpo;
    *cg::this_cluster().map_shared_rank(rM + rank * GM + g, o) = m;
    *cg::this_cluster().map_shared_rank(rL + rank * GM + g, o) = l;
  }
  // row(g) is the address of output row g (dh elements of type T)
  template <typename Row>
  __device__ __forceinline__ void finish(Row row) const {
    cluster_arrive();  // this block's pushes are done
    cluster_wait();    // and every peer's
    const int g0 = rank * rpo, g1 = min(G, g0 + rpo);
    for (int g = g0 + (int)threadIdx.x; g < g1; g += (int)blockDim.x) {
      float M = NEG_INF;
      for (int r = 0; r < n; ++r) M = fmaxf(M, rM[r * GM + g]);
      float L = 0.f;
      for (int r = 0; r < n; ++r) {
        const float c = expf(rM[r * GM + g] - M);
        rC[r * GM + g] = c;
        L += rL[r * GM + g] * c;
      }
      rS[g] = L;
    }
    __syncthreads();
    constexpr int C4 = DHP / 4;  // 4 elements a step
    for (int i = (int)threadIdx.x; i < (g1 - g0) * C4; i += (int)blockDim.x) {
      const int g = g0 + i / C4, d = (i % C4) * 4;
      if (d >= dh) continue;
      float A[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < n; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(rA + (r * rpo + g - g0) * RST + d);
        const float c = rC[r * GM + g];
        A[0] += a.x * c;
        A[1] += a.y * c;
        A[2] += a.z * c;
        A[3] += a.w * c;
      }
      const float L = rS[g];
      auto* out = row(g);
      using T = typename std::remove_pointer<decltype(out)>::type;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (d + j < dh) out[d + j] = from_f<T>(A[j] / (L == 0.f ? 1.f : L));
      }
    }
  }
};

// What a kernel's first launches found out, kept per kernel.
struct ClusterLaunch {
  bool attr_set = false;
  int fits[CLUSTER_MAX + 1] = {};  // by cluster size: 0 unknown, 1 fits, -1 does not
};

// One launch of `kern` on grid (n_split, ., .) in clusters of n_split
// blocks along x. Refuses (cudaErrorInvalidConfiguration) a cluster that
// cannot be co-resident at this kernel's shared-memory size
// (cudaOccupancyMaxActiveClusters == 0); never falls back.
template <typename Kern, typename... Args>
int launch_clustered(ClusterLaunch& st, Kern kern, int threads, int smem, dim3 grid,
                     int n_split, cudaStream_t stream, Args... args) {
  if (n_split < 1 || n_split > CLUSTER_MAX) return (int)cudaErrorInvalidValue;
  bool& attr_set = st.attr_set;
  int* fits = st.fits;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!fits[n_split]) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    fits[n_split] = n > 0 ? 1 : -1;
  }
  if (fits[n_split] < 0) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

// cp.async 16-byte copies (LDGSTS): src_bytes 0 zero-fills the 16 bytes
// without reading src.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// the same with each 8x8 matrix transposed: rows stored slot-major give
// the column-major B operand of mma.sync (V in P·V)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

}  // namespace
}  // namespace repro
