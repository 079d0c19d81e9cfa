// Fused diagonal-GMM E-step for Hopper (sm_90a), CUDA cores, fp32.
//
// Replaces the TPU kernel src/repro/kernels/gmm_estep/kernel.py
// (gmm_estep_kernel, body _kernel).  With the wrapper's operands
// a = 1/var, b = mean/var and const_k = log w_k - (sum mean^2/var +
// sum log var + D log 2pi) / 2, one pass over the points gives
//   lp_k   = const_k - 0.5 * (x*x).a_k + x.b_k
//   lse    = m + log(sum_k exp(lp_k - m)),  m = max_k lp_k
//   resp_k = exp(lp_k - m) / sum,  label = argmax_k lp_k (first on ties),
//            -1 where the row weight is 0
//   loglik = sum_n w_n lse_n,  r_sum = sum_n w_n resp,
//   r_x = sum_n (w_n resp) x_n,  r_x2 = sum_n (w_n resp) x_n^2
//
// What bounds it on this card: memory.  At the paper's shapes each row
// moves 4D + 4 bytes (x in, label out; 4 more with a mask) against ~5KD
// flops and K exp/log evaluations, below the fp32 ridge of the H100, so
// every point is read once: (a, b, const) and the tile's rows sit in
// shared memory, one thread owns a row's log-sum-exp, and the statistics
// leave the SM as one partial per block.  expf/logf are the accurate
// library versions: this file must not be built with --use_fast_math
// (EM's stop reads loglik).
//
// A block is one tile of kTileRows rows, one thread per row.  Past the
// 48 KB of shared memory a launch gets by default the launch opts in to
// more (up to the card's per-block maximum, which covers D = 130, K = 16);
// a shape beyond that is refused with an error.  A null w means every row
// weighs 1, so the unmasked sweeps read no weight vector.
//
// Determinism: no atomics.  Each block writes its partial
// [K + 2*K*D + 1] to its own slot of partials[R, S, M], one thread per
// output summing the tile's rows in row order; the host wrapper reduces
// over S with one fixed-order torch.sum.
//
// Plain C interface, bound with ctypes; every entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 256;              // rows per block = threads
constexpr size_t kDefaultShared = 48 * 1024;

size_t smem_bytes(int k, int d) {
  return sizeof(float) * (2 * static_cast<size_t>(k) * d + k
                          + static_cast<size_t>(kTileRows) * (d + k + 2));
}

__global__ void __launch_bounds__(kTileRows)
gmm_estep_kernel(const float* __restrict__ x, long long x_rstride,
                 const float* __restrict__ w, long long w_rstride,
                 const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ cst, int* __restrict__ labels,
                 float* __restrict__ partials, int n, int d, int k) {
  constexpr int rows = kTileRows;
  extern __shared__ float smem[];
  float* a_s = smem;                       // [K, D] 1/var
  float* b_s = a_s + k * d;                // [K, D] mean/var
  float* c_s = b_s + k * d;                // [K]    const
  float* x_s = c_s + k;                    // [rows, D]
  float* w_s = x_s + rows * d;             // [rows]
  float* l_s = w_s + rows;                 // [rows] w * lse
  float* p_s = l_s + rows;                 // [rows, K] lp, then w * resp

  const int r = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(tile) * rows;
  const int n_rows = static_cast<int>(min(static_cast<long long>(rows),
                                          n - row0));

  const long long pk = static_cast<long long>(r) * k;
  for (int i = tid; i < k * d; i += blockDim.x) {
    a_s[i] = a[pk * d + i];
    b_s[i] = b[pk * d + i];
  }
  for (int i = tid; i < k; i += blockDim.x) c_s[i] = cst[pk + i];
  const float* xr = x + r * x_rstride + row0 * d;
  for (int i = tid; i < n_rows * d; i += blockDim.x) x_s[i] = xr[i];
  if (w != nullptr) {
    const float* wr = w + r * w_rstride + row0;
    for (int i = tid; i < n_rows; i += blockDim.x) w_s[i] = wr[i];
  } else {
    for (int i = tid; i < n_rows; i += blockDim.x) w_s[i] = 1.f;
  }
  __syncthreads();

  if (tid < n_rows) {
    const float* xp = x_s + tid * d;
    float* lp = p_s + tid * k;
    float m = 0.f;
    int lab = 0;
    for (int kk = 0; kk < k; ++kk) {
      float quad = 0.f, lin = 0.f;
      for (int j = 0; j < d; ++j) {
        const float xv = xp[j];
        quad += (xv * xv) * a_s[kk * d + j];
        lin += xv * b_s[kk * d + j];
      }
      const float v = c_s[kk] - 0.5f * quad + lin;
      lp[kk] = v;
      if (kk == 0 || v > m) {              // strict: ties keep the first k
        m = v;
        lab = kk;
      }
    }
    float s = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const float e = expf(lp[kk] - m);
      lp[kk] = e;
      s += e;
    }
    const float wt = w_s[tid];
    for (int kk = 0; kk < k; ++kk) lp[kk] = (lp[kk] / s) * wt;
    l_s[tid] = (m + logf(s)) * wt;
    labels[static_cast<long long>(r) * n + row0 + tid] = wt > 0.f ? lab : -1;
  }
  __syncthreads();

  // one thread per output, rows in order: [r_sum K | r_x K*D | r_x2 K*D | ll]
  const int kd = k * d;
  const int m_out = k + 2 * kd + 1;
  float* out = partials + (static_cast<long long>(r) * n_tiles + tile) * m_out;
  for (int o = tid; o < m_out; o += blockDim.x) {
    float acc = 0.f;
    if (o < k) {
      for (int i = 0; i < n_rows; ++i) acc += p_s[i * k + o];
    } else if (o < k + kd) {
      const int kk = (o - k) / d, j = (o - k) % d;
      for (int i = 0; i < n_rows; ++i) acc += p_s[i * k + kk] * x_s[i * d + j];
    } else if (o < k + 2 * kd) {
      const int kk = (o - k - kd) / d, j = (o - k - kd) % d;
      for (int i = 0; i < n_rows; ++i) {
        const float xv = x_s[i * d + j];
        acc += p_s[i * k + kk] * (xv * xv);
      }
    } else {
      for (int i = 0; i < n_rows; ++i) acc += l_s[i];
    }
    out[o] = acc;
  }
}

}  // namespace

// Rows per block: the wrapper sizes partials [R, S, M] with
// S = ceil(N / gmm_estep_tile_rows).
extern "C" const int gmm_estep_tile_rows = kTileRows;

extern "C" {

// x [R|1, N, D] (restart stride x_rstride, 0 = shared), w [R|1, N]
// (stride w_rstride) or null for weight 1, a, b [R, K, D] and cst [R, K]
// contiguous fp32; labels [R, N] int32 and partials [R, S, K + 2*K*D + 1]
// fp32.  Returns cudaErrorInvalidValue for a shape the kernel does not
// take, else cudaGetLastError() after the launch.
int gmm_estep_launch(const void* x, long long x_rstride, const void* w,
                     long long w_rstride, const void* a, const void* b,
                     const void* cst, void* labels, void* partials, int r,
                     int n, int d, int k, void* stream) {
  if (n < 1 || r < 1 || r > 65535 || k < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k, d);
  if (smem > kDefaultShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_estep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();                  // clear it; report "too large"
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((n + kTileRows - 1) / kTileRows, r);
  gmm_estep_kernel<<<grid, kTileRows, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), x_rstride, static_cast<const float*>(w),
      w_rstride, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(cst), static_cast<int*>(labels),
      static_cast<float*>(partials), n, d, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
