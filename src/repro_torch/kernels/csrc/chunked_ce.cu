// Chunked cross-entropy forward over a large vocabulary, fp32, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/chunked_ce.py:chunked_cross_entropy
// (Pallas body _ce_kernel).  Same function: per token row of
// hidden (N,D) @ lm_head (D,V), the NLL logsumexp(logits) - logits[label] by
// an online logsumexp over vocab tiles, with the vocab and token tails masked
// and labels below 0 giving 0.  The (N, V) logits never exist in device
// memory.  The mean over valid rows is taken by the caller.
//
// What bounds it on the H100: fp32 FMAs.  At the slice's shape (N=B*T=1024,
// D=3584, V=152064) the product is 2*N*D*V = 1.12 TFLOP against 2.2 GB of
// lm_head, so the CUDA cores' 67 TFLOP/s set the bound (~17 ms); fp32 is the
// parity contract, so no TF32 tensor cores.
//
// Design.  The TPU grid is (token tiles, vocab tiles) with the vocab axis
// innermost and sequential, carrying m/l/gold in VMEM.  On Hopper that
// would give one block per 64-token tile, 16 blocks on 132 SMs.  So the grid
// is split over the vocab: block (token tile, vocab tile) computes one
// 128x128 logits tile as a register-tiled SGEMM (8x8 outputs per thread,
// 8-deep k slices through shared memory) and reduces it at once to a partial
// (max, sum-exp, gold) per row, written to a small [row][vocab tile] array.
// The token tile is the fastest grid index, so the blocks sharing one
// lm_head tile run together and read it from L2 rather than device memory.
// A second pass (one warp per row) folds the partials with the same online
// rule and writes the row's NLL.  Simple first: no wgmma, no TMA.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;        // token rows per block
constexpr int BN = 128;        // vocab columns per block
constexpr int BKD = 8;         // k slice through shared memory
constexpr int APAD = 4;        // As row padding: conflict-free transposed stores
constexpr int NTHREADS = 256;  // 16 x 16, 8x8 outputs each
constexpr float NEG_INF = -1e30f;

// thread-local row/column index -> tile index: two groups of 4, 64 apart, so
// the float4 shared-memory reads of a quarter warp hit distinct banks
__device__ __forceinline__ int split4(int t, int i) {
  return (i < 4) ? (t * 4 + i) : (64 + t * 4 + (i - 4));
}

__global__ void __launch_bounds__(NTHREADS)
ce_partial_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const int* __restrict__ labels, float* __restrict__ pm,
                  float* __restrict__ pl, float* __restrict__ pg, int N,
                  int D, int V, int nvt) {
  __shared__ __align__(16) float As[BKD][BM + APAD];
  __shared__ __align__(16) float Bs[BKD][BN];

  const int row0 = blockIdx.x * BM;
  const int vt = blockIdx.y;
  const int col0 = vt * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BKD) {
#pragma unroll
    for (int it = 0; it < (BM * BKD) / NTHREADS; ++it) {
      const int idx = tid + it * NTHREADS;
      const int r = idx / BKD;
      const int kk = idx % BKD;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < N && gk < D) ? h[(size_t)gr * D + gk] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < (BN * BKD) / NTHREADS; ++it) {
      const int idx = tid + it * NTHREADS;
      const int kk = idx / BN;
      const int c = idx % BN;
      const int gk = k0 + kk;
      const int gc = col0 + c;
      Bs[kk][c] = (gk < D && gc < V) ? w[(size_t)gk * V + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKD; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: this tile's (max, sum-exp, gold) per row; the 16 lanes that
  // share a row (same ty) reduce with 16-wide shuffles
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + split4(ty, i);
    const int lbl = gr < N ? labels[gr] : -1;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (col0 + split4(tx, j) < V) mx = fmaxf(mx, acc[i][j]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
    float se = 0.f, g = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + split4(tx, j);
      if (gc < V) {
        se += expf(acc[i][j] - mx);
        if (gc == lbl) g += acc[i][j];
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      se += __shfl_xor_sync(0xffffffffu, se, off, 16);
      g += __shfl_xor_sync(0xffffffffu, g, off, 16);
    }
    if (tx == 0 && gr < N) {
      const size_t o = (size_t)gr * nvt + vt;
      pm[o] = mx;
      pl[o] = se;
      pg[o] = g;
    }
  }
}

// one warp per row: fold the row's vocab-tile partials
__global__ void ce_combine_kernel(const float* __restrict__ pm,
                                  const float* __restrict__ pl,
                                  const float* __restrict__ pg,
                                  const int* __restrict__ labels,
                                  float* __restrict__ nll, int N, int nvt) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // warp-uniform
  float M = NEG_INF, L = 0.f, G = 0.f;
  for (int t = lane; t < nvt; t += 32) {
    const size_t o = (size_t)row * nvt + t;
    const float m = pm[o];
    const float mn = fmaxf(M, m);
    L = L * expf(M - mn) + pl[o] * expf(m - mn);
    M = mn;
    G += pg[o];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float Mo = __shfl_xor_sync(0xffffffffu, M, off);
    const float Lo = __shfl_xor_sync(0xffffffffu, L, off);
    const float Go = __shfl_xor_sync(0xffffffffu, G, off);
    const float mn = fmaxf(M, Mo);
    L = L * expf(M - mn) + Lo * expf(Mo - mn);
    M = mn;
    G += Go;
  }
  if (lane == 0) {
    const float logz = M + logf(fmaxf(L, 1e-30f));
    nll[row] = labels[row] >= 0 ? logz - G : 0.f;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `partials` holds 3*N*nvt floats
// (nvt = ceil(V/128), see ce_num_vocab_tiles); `nll` holds N floats.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int ce_num_vocab_tiles(int V) { return (V + BN - 1) / BN; }

extern "C" int ce_fwd(const float* h, const float* w, const int* labels,
                      float* partials, float* nll, int N, int D, int V,
                      void* stream) {
  if (N < 1 || D < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int nvt = (V + BN - 1) / BN;
  if (nvt > 65535) return (int)cudaErrorInvalidValue;
  float* pm = partials;
  float* pl = pm + (size_t)N * nvt;
  float* pg = pl + (size_t)N * nvt;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((N + BM - 1) / BM, nvt);
  ce_partial_kernel<<<grid, NTHREADS, 0, s>>>(h, w, labels, pm, pl, pg, N, D,
                                              V, nvt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (int)(((size_t)N * 32 + threads - 1) / threads);
  ce_combine_kernel<<<blocks, threads, 0, s>>>(pm, pl, pg, labels, nll, N,
                                               nvt);
  return (int)cudaGetLastError();
}
