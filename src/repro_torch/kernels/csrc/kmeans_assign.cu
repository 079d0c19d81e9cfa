// Fused k-means assignment sweep for Hopper (sm_90a), CUDA cores, fp32.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign/kernel.py
// (kmeans_assign_kernel, body _kernel): one pass over the points gives
//   d2     = |x|^2 - 2 x.c + |c|^2            (the reference's expansion)
//   label  = argmin_k d2 (first index on ties), -1 where the row weight is 0
//   J      = sum_n w_n * max(min_k d2, 0)
//   sums   = sum_n w_n x_n over the rows of each cluster,  counts = sum_n w_n
//
// What bounds it on this card: memory.  At the paper's shapes (D = 3..11,
// K = 2..10) each row costs 4D + 4 bytes of HBM traffic (x in, label out;
// 4 more with a mask) against ~3KD flops, far below the H100's ~20
// flop/byte fp32 ridge, so the kernel reads each point exactly once and
// keeps everything else on chip: the centroids and the tile's rows sit
// in shared memory, the per-row argmin is one thread's loop over K, and
// the statistics leave the SM as one small partial per block.
//
// A block is one tile of kTileRows rows, one thread per row.  Its shared
// memory grows with K and D; past the 48 KB a launch gets by default the
// launch opts in to more (up to the card's per-block maximum, which covers
// D = 130, K = 16), and a shape beyond that is refused with an error.
// A null w means every row weighs 1: the unmasked sweeps of the main path
// then read no weight vector at all.
//
// Determinism: the k-means stop compares parameters bitwise, so the sums
// must not change from run to run.  No atomics: each block writes its
// partial [K*D + K + 1] to its own slot of partials[R, S, M] (each output
// summed over the tile's rows in row order by one thread), and the host
// wrapper reduces over S with one fixed-order torch.sum.
//
// Plain C interface, bound with ctypes; every entry point returns
// cudaGetLastError() so a refused launch is reported at the call.

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 256;              // rows per block = threads
constexpr size_t kDefaultShared = 48 * 1024;

size_t smem_bytes(int k, int d) {
  return sizeof(float) * (static_cast<size_t>(k) * d + k
                          + static_cast<size_t>(kTileRows) * (d + 2))
         + sizeof(int) * static_cast<size_t>(kTileRows);
}

__global__ void __launch_bounds__(kTileRows)
kmeans_assign_kernel(const float* __restrict__ x, long long x_rstride,
                     const float* __restrict__ w, long long w_rstride,
                     const float* __restrict__ c,
                     int* __restrict__ labels, float* __restrict__ partials,
                     int n, int d, int k) {
  constexpr int rows = kTileRows;
  extern __shared__ float smem[];
  float* c_s = smem;                       // [K, D] centroids
  float* c2_s = c_s + k * d;               // [K]   |c|^2
  float* x_s = c2_s + k;                   // [rows, D] the tile's points
  float* w_s = x_s + rows * d;             // [rows] weights
  float* j_s = w_s + rows;                 // [rows] w * max(min d2, 0)
  int* lab_s = reinterpret_cast<int*>(j_s + rows);   // [rows] argmin

  const int r = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(tile) * rows;
  const int n_rows = static_cast<int>(min(static_cast<long long>(rows),
                                          n - row0));

  const float* cr = c + static_cast<long long>(r) * k * d;
  for (int i = tid; i < k * d; i += blockDim.x) c_s[i] = cr[i];
  const float* xr = x + r * x_rstride + row0 * d;
  for (int i = tid; i < n_rows * d; i += blockDim.x) x_s[i] = xr[i];
  if (w != nullptr) {
    const float* wr = w + r * w_rstride + row0;
    for (int i = tid; i < n_rows; i += blockDim.x) w_s[i] = wr[i];
  } else {
    for (int i = tid; i < n_rows; i += blockDim.x) w_s[i] = 1.f;
  }
  __syncthreads();
  for (int kk = tid; kk < k; kk += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s += c_s[kk * d + j] * c_s[kk * d + j];
    c2_s[kk] = s;
  }
  __syncthreads();

  if (tid < n_rows) {
    const float* xp = x_s + tid * d;
    float x2 = 0.f;
    for (int j = 0; j < d; ++j) x2 += xp[j] * xp[j];
    float best = 0.f;
    int lab = 0;
    for (int kk = 0; kk < k; ++kk) {
      const float* cp = c_s + kk * d;
      float dot = 0.f;
      for (int j = 0; j < d; ++j) dot += xp[j] * cp[j];
      const float d2 = x2 - 2.f * dot + c2_s[kk];
      if (kk == 0 || d2 < best) {        // strict: ties keep the first k
        best = d2;
        lab = kk;
      }
    }
    const float wt = w_s[tid];
    lab_s[tid] = lab;
    j_s[tid] = fmaxf(best, 0.f) * wt;
    labels[static_cast<long long>(r) * n + row0 + tid] = wt > 0.f ? lab : -1;
  }
  __syncthreads();

  // one thread per output, rows summed in order: [sums K*D | counts K | J]
  const int m = k * d + k + 1;
  float* out = partials + (static_cast<long long>(r) * n_tiles + tile) * m;
  for (int o = tid; o < m; o += blockDim.x) {
    float acc = 0.f;
    if (o < k * d) {
      const int kk = o / d, j = o % d;
      for (int i = 0; i < n_rows; ++i)
        if (lab_s[i] == kk) acc += x_s[i * d + j] * w_s[i];
    } else if (o < k * d + k) {
      const int kk = o - k * d;
      for (int i = 0; i < n_rows; ++i)
        if (lab_s[i] == kk) acc += w_s[i];
    } else {
      for (int i = 0; i < n_rows; ++i) acc += j_s[i];
    }
    out[o] = acc;
  }
}

}  // namespace

// Rows per block: the wrapper sizes partials [R, S, M] with
// S = ceil(N / kmeans_assign_tile_rows).
extern "C" const int kmeans_assign_tile_rows = kTileRows;

extern "C" {

// x [R|1, N, D] (restart stride x_rstride elements, 0 = shared),
// w [R|1, N] (stride w_rstride) or null for weight 1, c [R, K, D]
// contiguous fp32; labels [R, N] int32 and partials [R, S, K*D + K + 1]
// fp32.  Returns cudaErrorInvalidValue for a shape the kernel does not
// take, else cudaGetLastError() after the launch.
int kmeans_assign_launch(const void* x, long long x_rstride, const void* w,
                         long long w_rstride, const void* c, void* labels,
                         void* partials, int r, int n, int d, int k,
                         void* stream) {
  if (n < 1 || r < 1 || r > 65535 || k < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k, d);
  if (smem > kDefaultShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();                  // clear it; report "too large"
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((n + kTileRows - 1) / kTileRows, r);
  kmeans_assign_kernel<<<grid, kTileRows, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), x_rstride, static_cast<const float*>(w),
      w_rstride, static_cast<const float*>(c), static_cast<int*>(labels),
      static_cast<float*>(partials), n, d, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
