// GQA flash-attention forward for Hopper (sm_90a), CUDA cores, fp32 math.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _attn_kernel): for query head h of batch b,
// with kv head h / (Hq / Hkv),
//   s   = (q * scale) . k^T                         in fp32, q pre-scaled
//   s   = -1e30 where masked: causal (row >= col), sliding window
//         (row - window < col <= row) or none (bidirectional)
//   o   = softmax(s) . v                            online: (m, l, acc)
//   out = acc / max(l, 1e-30), rounded to q's dtype
//
// What bounds it on this card: operations.  At the qwen3-8b prefill
// (S = 2048, dh = 128, causal) the kernel does ~34 GFLOP against ~42 MB of
// q/k/v/o, some 800 flop per byte.  The reference keeps P in fp32 for P.V,
// which the bf16 tensor cores would round, so this first kernel runs every
// product as an fp32 FMA on the CUDA cores (67 TFLOP/s peak, not the 989
// of bf16 tensor cores) and is bound by them and by the shared-memory
// reads feeding them.  The design keeps every intermediate on chip: the
// block's q tile, one k/v tile at a time and the probabilities live in
// shared memory; m, l and the output accumulator live in registers; HBM
// sees each q row and each output row once and each k/v row once per q
// tile that can see it.
//
// Grid: one block per (q tile of kBlockQ rows, query head, batch).  The
// block loops over the kv tiles itself, so the online-softmax state never
// leaves it (the TPU kernel carried it across a sequential grid axis,
// which parallel GPU blocks cannot do).  Each block owns its output rows:
// no atomics, and two runs give the same bits.  A kv tile is visited only
// if some (row, col) of the block can see it: a causal block stops at its
// last row's diagonal, a window block starts at its first row's window.
// The ragged last kv tile is masked by the real Skv and its rows are
// zero-filled in shared memory; there is no padding in HBM.
//
// The -1e30 start of m is the reference's finite sentinel: a row whose
// first visited tile is all masked gets p = exp(0) = 1 there, which the
// next visible tile wipes with alpha = exp(-1e30 - m) = 0.  -INFINITY would
// give NaN (-inf - -inf).  A row that sees no column at all (only a window
// with Sq >= Skv + window) gets 0 where the plain version averages v.
//
// Threads: 256 as a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and,
// of a kv tile, columns tx + 16 j (i, j < 4), and of the output, columns
// tx + 16 c.  Row maxima and sums are reduced over the 16 tx lanes of a
// half warp with shuffles.  Accurate expf; build without --use_fast_math.
//
// Plain C interface, bound with ctypes; the entry point returns
// cudaGetLastError() so a refused launch is reported at the call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kBlockK = 64;                 // kv columns per tile
constexpr int kThreads = 256;               // 16 x 16
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1.0e30f;         // the reference's sentinel
constexpr size_t kDefaultShared = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// q [kBlockQ][dh + 1], k^T [dh][kBlockK + 1], v [kBlockK][dh],
// p [kBlockQ][kBlockK + 1]; the +1 strides keep the reads conflict-free
size_t smem_bytes(int dh) {
  return sizeof(float) *
         (static_cast<size_t>(kBlockQ) * (dh + 1) +
          static_cast<size_t>(dh) * (kBlockK + 1) +
          static_cast<size_t>(kBlockK) * dh +
          static_cast<size_t>(kBlockQ) * (kBlockK + 1));
}

// kChunks = ceil(dh / 16) rounded up to the instance: output columns per
// thread
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int sq, int skv, int dh, int causal,
                       int window, float scale) {
  extern __shared__ float smem[];
  const int qs = dh + 1;
  constexpr int ks = kBlockK + 1;
  float* q_s = smem;                        // scaled q tile
  float* kt_s = q_s + kBlockQ * qs;         // k tile, transposed
  float* v_s = kt_s + dh * ks;              // v tile
  float* p_s = v_s + kBlockK * dh;          // probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // the last q tiles see the most kv tiles under a causal mask: start them
  // first so the tail of the grid is short
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int nq = min(kBlockQ, sq - q0);
  const T* qp = q + ((static_cast<long long>(b) * hq + h) * sq + q0) * dh;
  const T* kp = k + (static_cast<long long>(b) * hkv + hk) * skv * dh;
  const T* vp = v + (static_cast<long long>(b) * hkv + hk) * skv * dh;

  for (int i = tid; i < kBlockQ * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    q_s[r * qs + d] = r < nq ? to_f32(qp[i]) * scale : 0.f;
  }

  // the kv columns any row of this block can see
  const bool lower = causal != 0 || window > 0;
  int k_lo = 0, k_hi = skv;
  if (lower) k_hi = min(skv, q0 + nq);
  if (window > 0) k_lo = max(0, q0 - window + 1);

  float m[4], l[4], acc[4][kChunks];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / kBlockK) * kBlockK; k0 < k_hi; k0 += kBlockK) {
    const int nk = min(kBlockK, skv - k0);
    __syncthreads();                        // previous tile fully read
    const T* kt = kp + static_cast<long long>(k0) * dh;
    const T* vt = vp + static_cast<long long>(k0) * dh;
    for (int i = tid; i < kBlockK * dh; i += kThreads) {
      const int c = i / dh, d = i - c * dh;
      const bool in = c < nk;
      kt_s[d * ks + c] = in ? to_f32(kt[i]) : 0.f;
      v_s[i] = in ? to_f32(vt[i]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * qs + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt_s[d * ks + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool vis = col < skv;
        if (lower) vis = vis && row >= col;
        if (window > 0) vis = vis && col > row - window;
        if (!vis) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * ks + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                        // p tile complete

    for (int cc = 0; cc < nk; ++cc) {
      float vv[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < dh ? v_s[cc * dh + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * ks + cc];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    T* orow = o + ((static_cast<long long>(b) * hq + h) * sq + q0 + r) * dh;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) store(orow + d, acc[i][c] / denom);
    }
  }
}

template <typename T, int kChunks>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int dh, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  auto* fn = flash_attention_kernel<T, kChunks>;
  if (smem > kDefaultShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, hq, b);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, dh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(const void* q, const void* k, const void* v, void* o,
                      int b, int hq, int hkv, int sq, int skv, int dh,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 4>(q, k, v, o, b, hq, hkv, sq, skv, dh, causal, window,
                        scale, stream);
  if (dh <= 128)
    return launch<T, 8>(q, k, v, o, b, hq, hkv, sq, skv, dh, causal, window,
                        scale, stream);
  return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, skv, dh, causal, window,
                       scale, stream);
}

}  // namespace

extern "C" {

// q [B, Hq, Sq, dh], k/v [B, Hkv, Skv, dh], o [B, Hq, Sq, dh], contiguous,
// fp32 (bf16 = 0) or bf16 (bf16 = 1); window <= 0 means none.  Returns
// cudaErrorInvalidValue for a shape the kernel does not take, else
// cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int hq, int hkv, int sq, int skv,
                           int dh, int causal, int window, float scale,
                           int bf16, void* stream) {
  if (b < 1 || b > 65535 || hq < 1 || hq > 65535 || hkv < 1 || hq % hkv ||
      sq < 1 || skv < 1 || dh < 1 || dh > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv,
                                            dh, causal, window, scale, s);
  return dispatch_head_dim<float>(q, k, v, o, b, hq, hkv, sq, skv, dh,
                                  causal, window, scale, s);
}

}  // extern "C"
