// Flash attention forward (GQA, causal, sliding window), fp32, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (Pallas body _attn_kernel).  Same function: q (B,Tq,Hq,D), k/v (B,Tk,Hkv,D),
// kv head = q head / (Hq/Hkv) for any group size (7 on qwen2-7b), causal and
// sliding-window masks offset by q_offset, online softmax in fp32, ragged kv
// rows loaded as zeros, fully masked kv tiles skipped with the TPU kernel's
// predicate, output (B,Tq,Hq,D).
//
// What bounds it on the H100: fp32 FMAs.  At the slice's shape (B=4, T=256,
// Hq=28, D=128, causal) the work is ~1.9 GFLOP against ~34 MB of q/k/v/o, far
// above the fp32 ridge point, so the CUDA cores' 67 TFLOP/s set the bound.
// The parity contract is fp32 (TF32 keeps ~3 digits), so no tensor cores.
//
// Design: the TPU grid walks kv tiles in order and carries m/l/acc in VMEM
// scratch; Hopper blocks run in no order, so the kv walk is a loop inside one
// block.  One block per (q tile of 64 rows, q head, batch), 256 threads as a
// 16x16 grid: thread (ty, tx) owns q rows ty+16i (i<4), the S columns
// tx+16j (j<2) of each 32-row kv tile and the output columns tx+16c (c<8).
// Its rows' running max / sum live in registers, replicated over the 16
// lanes of the row (reduced with 16-wide shuffles), and its 4x8 output
// accumulator lives in registers.  Q, K and V tiles sit in shared memory with
// a row stride of D+1 floats so the column walks are bank-conflict free; P
// goes through shared memory once per kv tile for the P@V product.
// Simple first: no wgmma, no TMA, no double buffering.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // kv rows per inner tile
constexpr int DMAX = 128;       // largest head_dim taken
constexpr int NTHREADS = 256;   // 16 x 16
constexpr float NEG_INF = -1e30f;

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
}

__global__ void __launch_bounds__(NTHREADS)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                int Tq, int Tk, int Hq, int Hkv, int D, float scale,
                int causal, int window, int q_offset) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;                 // BQ x ld
  float* Ks = Qs + BQ * ld;         // BK x ld
  float* Vs = Ks + BK * ld;         // BK x ld
  float* Ps = Vs + BK * ld;         // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // q tile, pre-scaled as in the reference; rows past Tq load as zeros
  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int t = q0 + r;
    float val = 0.f;
    if (t < Tq) val = q[(((size_t)b * Tq + t) * Hq + h) * D + d] * scale;
    Qs[r * ld + d] = val;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Tk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    // dead-tile skip, the predicate of the TPU kernel (block-uniform)
    if (causal && !(k0 <= q0 + q_offset + BQ - 1)) continue;
    if (window && !(k0 + BK - 1 > q0 + q_offset - window)) continue;

    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    // kv tile; rows past Tk load as zeros so no garbage reaches P@V
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int r = idx / D;
      const int d = idx - r * D;
      const int t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * Hkv + hk) * D + d;
        kv = k[off];
        vv = v[off];
      }
      Ks[r * ld + d] = kv;
      Vs[r * ld + d] = vv;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + q_offset;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = NEG_INF;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off, 16);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      Ps[(ty + 16 * i) * (BK + 1) + tx] = p0;
      Ps[(ty + 16 * i) * (BK + 1) + tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? Vs[kk * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* out = o + (((size_t)b * Tq + t) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) out[col] = acc[i][c] / denom;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int attn_fwd(const float* q, const float* k, const float* v,
                        float* o, int B, int Tq, int Tk, int Hq, int Hkv,
                        int D, float scale, int causal, int window,
                        int q_offset, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || D < 1 || D > DMAX || Hkv < 1 ||
      Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  attn_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, o, Tq, Tk, Hq, Hkv, D, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}
