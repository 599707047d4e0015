// RWKV6 (Finch) WKV scan forward, fp32, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_scan (Pallas
// body _rwkv6_kernel).  Same function: per (batch b, head h), with the state
// S of shape (D, D) in fp32 and per-channel decay d_t = exp(-exp(w_t)),
//   y_t = r_t (S_{t-1} + diag(u_h) k_t^T v_t)
//   S_t = diag(d_t) S_{t-1} + k_t^T v_t
// Returns y (B,T,H,D) and the final state (B,H,D,D); the initial state is an
// input.  When exp(w) overflows to +inf the decay is exp(-inf) = 0 exactly.
//
// What bounds it on the H100.  At the slice's shape (B 4, T 256, H 64,
// D 64) the least work is 5*D*D + 5*D flops per (b, h, t): r S_{t-1} and
// S = d S + k^T v per state element, and the bonus v_e * sum_d r_d u_d k_d
// per row, 1.35 GFLOP, 0.020 ms at the 67 TFLOP/s fp32 peak.  Its bytes
// (r, k, v, w, y, u, and the state in and out) are ~92 MB, 0.0275 ms at
// 3.35 TB/s, so bytes bound it.  This kernel does 7*D*D (the bonus inside
// the per-element loop), still under the byte time.  B*H = 256 independent
// scans run over 132 SMs.
//
// Design.  The TPU grid walks time chunks in order with the state in VMEM
// and steps sequentially inside each chunk (the per-channel decay makes a
// chunked matmul form unsafe; the reference keeps the sequential form, and
// so does this kernel).  Hopper has no sequential grid axis, so one block per
// (b, h) walks all of T itself.  The state never leaves registers: thread
// (e, q) owns column e and the rows d = q, q + tpc, ... (tpc threads per
// column, at most 16 rows each; tpc = 4 at the slice's shape, 256 threads).
// Each chunk of up to 32 steps stages r, k, v and the decay (exp(-exp(w)),
// computed once per element while staging) in shared memory; y_t's
// reduction over d is a tpc-wide shuffle, and S advances only after y_t has
// read S_{t-1}.  The loop ends at T, so the state never advances past it.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_RPT = 16;              // state rows per thread
constexpr int STEPS_PER_CHUNK = 32;      // time steps staged at once
constexpr int SMEM_BUDGET = 48 * 1024;   // no opt-in above 48 KB needed

__global__ void wkv6_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ sT, int T, int H, int D,
    int tpc, int tc) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;            // [tc][D]
  float* ks = rs + tc * D;     // [tc][D]
  float* vs = ks + tc * D;     // [tc][D]
  float* ds = vs + tc * D;     // [tc][D] decay

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int e = tid / tpc;
  const int q = tid % tpc;
  const bool col_ok = e < D;

  float st[MAX_RPT];
  float ur[MAX_RPT];
  const size_t sbase = (size_t)bh * D * D + (col_ok ? e : 0);
#pragma unroll
  for (int j = 0; j < MAX_RPT; ++j) {
    const int d = q + j * tpc;
    st[j] = (col_ok && d < D) ? s0[sbase + (size_t)d * D] : 0.f;
    ur[j] = d < D ? u[h * D + d] : 0.f;
  }

  for (int t0 = 0; t0 < T; t0 += tc) {
    const int steps = min(tc, T - t0);
    const size_t bt0 = (size_t)b * T + t0;
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < steps * D; i += blockDim.x) {
      const int s = i / D;
      const size_t g = ((bt0 + s) * H + h) * D + (i - s * D);
      rs[i] = r[g];
      ks[i] = k[g];
      vs[i] = v[g];
      ds[i] = expf(-expf(w[g]));
    }
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      const float ve = col_ok ? vs[s * D + e] : 0.f;
      const float* rt = rs + s * D;
      const float* kt = ks + s * D;
      const float* dt = ds + s * D;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_RPT; ++j) {
        const int d = q + j * tpc;
        if (d < D) {
          const float kv = kt[d] * ve;
          acc = fmaf(rt[d], fmaf(ur[j], kv, st[j]), acc);
          st[j] = fmaf(dt[d], st[j], kv);
        }
      }
      for (int off = tpc >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (col_ok && q == 0) y[((bt0 + s) * H + h) * D + e] = acc;
    }
  }

  if (col_ok) {
#pragma unroll
    for (int j = 0; j < MAX_RPT; ++j) {
      const int d = q + j * tpc;
      if (d < D) sT[sbase + (size_t)d * D] = st[j];
    }
  }
}

// threads per state column: the least power of two that keeps a thread's
// rows within MAX_RPT registers
int threads_per_col(int D) {
  int tpc = 1;
  while (tpc * MAX_RPT < D) tpc <<= 1;
  return tpc;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All tensors fp32, contiguous:
// r, k, v, w and y (B,T,H,D), u (H,D), s0 and sT (B,H,D,D).  wkv6_supported
// says whether D fits the block (1 if so).  wkv6_fwd launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int wkv6_supported(int D) {
  if (D < 1) return 0;
  const int tpc = threads_per_col(D);
  if (tpc > 32 || D * tpc > 1024) return 0;
  return (int)(4 * D * sizeof(float)) <= SMEM_BUDGET;
}

extern "C" int wkv6_fwd(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* s0,
                        float* y, float* sT, int B, int T, int H, int D,
                        void* stream) {
  if (B < 1 || T < 1 || H < 1 || !wkv6_supported(D))
    return (int)cudaErrorInvalidValue;
  const int tpc = threads_per_col(D);
  const int threads = (D * tpc + 31) / 32 * 32;
  const int per_step = 4 * D * (int)sizeof(float);
  const int tc = min(STEPS_PER_CHUNK, SMEM_BUDGET / per_step);
  wkv6_scan_kernel<<<B * H, threads, (size_t)tc * per_step,
                     (cudaStream_t)stream>>>(r, k, v, w, u, s0, y, sT, T, H,
                                             D, tpc, tc);
  return (int)cudaGetLastError();
}
