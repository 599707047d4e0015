// Mamba2 SSD scan forward, fp32, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py:mamba2_scan (Pallas
// body _ssd_kernel).  Same function: per (batch b, head h), with the state
// h_t of shape (P, N) in fp32,
//   h_t = exp(A_h * dt_t) * h_{t-1} + dt_t * x_t (outer) B_t
//   y_t = h_t . C_t + D_h * x_t
// where B_t and C_t (N) are shared by every head.  Returns y (B,T,H,P) and
// the final state (B,H,P,N); the initial state is an input.
//
// What bounds it on the H100.  At the slice's shape (B 4, T 256, H 32, P 64,
// N 128) the recurrence is 5*P*N + 3*P flops per (b, h, t) (decay, input
// and output per state element): 1.34 GFLOP, 0.020 ms at the 67 TFLOP/s
// fp32 peak; its bytes (x, y, dt, B, C, and the state in and out) are
// ~26 MB, 0.008 ms at 3.35 TB/s.  So fp32 operations bound it,
// and only B*H = 128 independent scans exist to spread over 132 SMs.
//
// Design.  The TPU kernel walks time chunks in grid order with the state in
// VMEM and does the chunked (matmul) SSD form on the MXU.  Hopper has no
// sequential grid axis, so one block per (b, h) walks all of T itself, in
// the sequential form (exact, and no exp of a positive number anywhere).  The
// state never leaves registers: thread (p, r) owns row p and the columns
// n = r, r + tpr, ... (tpr threads per row, at most 32 columns each; tpr = 4
// at the slice's shape, 256 threads).  Each chunk of up to 32 steps stages
// B_t, C_t (shared by all rows), x_t and dt_t in shared memory, so the step
// loop reads only shared memory and registers; y_t's reduction over n is a
// tpr-wide shuffle.  The loop ends at T, so a ragged T needs no padding.
// Simple first: no chunked form on tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_NPT = 32;              // state columns per thread
constexpr int STEPS_PER_CHUNK = 32;      // time steps staged at once
constexpr int SMEM_BUDGET = 48 * 1024;   // no opt-in above 48 KB needed

__global__ void ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ Dskip,
    const float* __restrict__ s0, float* __restrict__ y,
    float* __restrict__ sT, int T, int H, int P, int N, int tpr, int tc) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;            // [tc][N]
  float* Cs = Bs + tc * N;     // [tc][N]
  float* xs = Cs + tc * N;     // [tc][P]
  float* dts = xs + tc * P;    // [tc]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int p = tid / tpr;
  const int r = tid % tpr;
  const bool row_ok = p < P;
  const float a = A[h];
  const float dskip = Dskip[h];

  float st[MAX_NPT];
  const size_t sbase = ((size_t)bh * P + (row_ok ? p : 0)) * N;
#pragma unroll
  for (int j = 0; j < MAX_NPT; ++j) {
    const int n = r + j * tpr;
    st[j] = (row_ok && n < N) ? s0[sbase + n] : 0.f;
  }

  for (int t0 = 0; t0 < T; t0 += tc) {
    const int steps = min(tc, T - t0);
    const size_t bt0 = (size_t)b * T + t0;
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < steps * N; i += blockDim.x) {
      Bs[i] = Bm[bt0 * N + i];
      Cs[i] = Cm[bt0 * N + i];
    }
    for (int i = tid; i < steps * P; i += blockDim.x) {
      const int s = i / P;
      xs[i] = x[((bt0 + s) * H + h) * P + (i - s * P)];
    }
    for (int i = tid; i < steps; i += blockDim.x)
      dts[i] = dt[(bt0 + i) * H + h];
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      const float d = dts[s];
      const float da = expf(a * d);
      const float xv = row_ok ? xs[s * P + p] : 0.f;
      const float dx = d * xv;
      const float* Bt = Bs + s * N;
      const float* Ct = Cs + s * N;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_NPT; ++j) {
        const int n = r + j * tpr;
        if (n < N) {
          st[j] = fmaf(da, st[j], dx * Bt[n]);
          acc = fmaf(st[j], Ct[n], acc);
        }
      }
      for (int off = tpr >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (row_ok && r == 0) y[((bt0 + s) * H + h) * P + p] = fmaf(dskip, xv, acc);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int j = 0; j < MAX_NPT; ++j) {
      const int n = r + j * tpr;
      if (n < N) sT[sbase + n] = st[j];
    }
  }
}

// threads per state row: the least power of two that keeps a thread's
// columns within MAX_NPT registers
int threads_per_row(int N) {
  int tpr = 1;
  while (tpr * MAX_NPT < N) tpr <<= 1;
  return tpr;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All tensors fp32, contiguous:
// x (B,T,H,P), dt (B,T,H), A (H), Bm and Cm (B,T,N), D (H), s0 and sT
// (B,H,P,N), y (B,T,H,P).  ssd_supported says whether (P, N) fits the
// block (1 if so).  ssd_fwd launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
extern "C" int ssd_supported(int P, int N) {
  if (P < 1 || N < 1) return 0;
  const int tpr = threads_per_row(N);
  if (tpr > 32 || P * tpr > 1024) return 0;
  return (int)((2 * N + P + 1) * sizeof(float)) <= SMEM_BUDGET;
}

extern "C" int ssd_fwd(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* D,
                       const float* s0, float* y, float* sT, int B, int T,
                       int H, int P, int N, void* stream) {
  if (B < 1 || T < 1 || H < 1 || !ssd_supported(P, N))
    return (int)cudaErrorInvalidValue;
  const int tpr = threads_per_row(N);
  const int threads = (P * tpr + 31) / 32 * 32;
  const int per_step = (2 * N + P + 1) * (int)sizeof(float);
  const int tc = min(STEPS_PER_CHUNK, SMEM_BUDGET / per_step);
  ssd_scan_kernel<<<B * H, threads, (size_t)tc * per_step,
                    (cudaStream_t)stream>>>(x, dt, A, Bm, Cm, D, s0, y, sT, T,
                                            H, P, N, tpr, tc);
  return (int)cudaGetLastError();
}
