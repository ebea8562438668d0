// Backward of the training-mode fused BatchNorm + activation for Hopper
// (sm_90a): the InPlace-ABN backward, which rebuilds the normalized
// pre-activation from the stored output y instead of keeping x.
//
// Replaces the two Pallas TPU kernels that `_abn_bwd_rows` launches
// (vae2_tpu/ops/pallas/abn.py:180-224):
//
// - kernel 2, `_sums_kernel` (abn.py:135-159): per channel,
//     z, dz_eff = act_invert(y, dz);  y_norm = (z - beta) / gamma
//     edz = sum(dz_eff),  eydz = sum(y_norm * dz_eff)   over R rows;
// - kernel 3, `_dx_kernel` (abn.py:162-177):
//     dx = (dz_eff - edz * inv_n - y_norm * eydz * inv_n) * mul
//   with inv_n = 1 / R and mul = gamma * rsqrt(var + eps).
//
// The buffers are channels-last rows, R = N*H*W by C, in f32 or bf16;
// gamma, beta, mul and the sums are f32; everything is computed in f32.
// The activations are inverted as the JAX package inverts them (abn.py:
// 68-78): leaky_relu by y / slope, elu by log(max(1 + y, 1e-12)), and
// y_norm divides by the raw gamma. Each multiply, add and divide is
// rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn), in the order of the
// JAX expressions, so that the plain PyTorch versions compute the same bits
// wherever the summation order does not enter.
//
// What bounds them: bytes. Kernel 2 reads y and dz (2 * R * C * sizeof(T)
// bytes), kernel 3 reads both and writes dx (3 * R * C * sizeof(T)); both
// do a few flops per element, far below the card's operations per byte.
//
// What the design does about it. Both kernels walk the buffers as one flat
// grid-stride pass of 16-byte vectors (8 bf16 or 4 f32 values) and size
// the grid so that its stride is a multiple of C: every thread meets the
// same V channels on every iteration, so gamma, beta and the other
// per-channel values sit in registers, and the loop is two 16-byte loads,
// the arithmetic, and (kernel 3) a 16-byte store. Buffers that are not
// 16-byte aligned, or whose length is not a multiple of V, take the same
// pass with V = 1.
//
// Kernel 2 is DETERMINISTIC: the same inputs give the same bits on every
// run. Each thread keeps f32 partial sums of its V channels in registers;
// at the end the block writes them to shared memory and sums each channel's
// slots in a fixed order into one row of a (blocks, 2, C) workspace; a
// second small launch reduces each of the 2*C columns over the blocks with
// a fixed tree. No atomics. (The Pallas kernel accumulates in grid order
// and is deterministic too.)
//
// Interface: plain C, for ctypes. Each launcher returns cudaGetLastError()
// after its launches; they run on the caller's stream and allocate
// nothing: vae2_abn_bwd_sums_workspace() says how many floats of scratch
// vae2_abn_bwd_sums() needs for the same arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumsBlocksPerSm = 4;
constexpr int kDxBlocksPerSm = 8;

enum Act { kNone = 0, kLeakyRelu = 1, kElu = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(float v) { return v; }
__device__ __forceinline__ float load_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// V consecutive values starting at element iv * V, as f32.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, int64_t iv,
                                         float (&out)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    union {
      uint4 u;
      T v[V];
    } pk;
    pk.u = reinterpret_cast<const uint4*>(p)[iv];
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = load_f32(pk.v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = load_f32(p[iv * V + k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int64_t iv,
                                          const float (&in)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    union {
      uint4 u;
      T v[V];
    } pk;
#pragma unroll
    for (int k = 0; k < V; ++k) pk.v[k] = store_as<T>(in[k]);
    reinterpret_cast<uint4*>(p)[iv] = pk.u;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[iv * V + k] = store_as<T>(in[k]);
  }
}

// (pre-activation z, effective gradient dz_eff) from the output y
// (abn.py:68-78).
template <int ACT>
__device__ __forceinline__ void act_invert(float y, float dz, float slope,
                                           float& z, float& dz_eff) {
  if (ACT == kElu && y < 0.f) {
    z = logf(fmaxf(__fadd_rn(1.f, y), 1e-12f));
    dz_eff = __fmul_rn(dz, __fadd_rn(y, 1.f));
  } else if (ACT == kLeakyRelu && y < 0.f) {
    z = __fdiv_rn(y, slope);
    dz_eff = __fmul_rn(dz, slope);
  } else {
    z = y;
    dz_eff = dz;
  }
}

// ---- kernel 2, stage 1: per-block partial sums ----------------------------
// Launch: blockDim.x == kThreads, gridDim.x * kThreads * V a multiple of c,
// n a multiple of V, dynamic shared memory 2 * kThreads * V floats.
template <typename T, int ACT, int V>
__global__ void __launch_bounds__(kThreads)
abn_bwd_sums_partial(const T* __restrict__ y, const T* __restrict__ dz,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     float* __restrict__ partial, int64_t n, int c,
                     float slope) {
  extern __shared__ float smem[];
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  float g[V], b[V], se[V], sey[V];
  int ch = (int)((tid * V) % c);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    g[k] = gamma[ch];
    b[k] = beta[ch];
    se[k] = 0.f;
    sey[k] = 0.f;
    if (++ch == c) ch = 0;
  }
  const int64_t n_vec = n / V;
  for (int64_t iv = tid; iv < n_vec; iv += stride) {
    float yv[V], dv[V];
    load_vec<T, V>(y, iv, yv);
    load_vec<T, V>(dz, iv, dv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float z, de;
      act_invert<ACT>(yv[k], dv[k], slope, z, de);
      const float yn = __fdiv_rn(__fsub_rn(z, b[k]), g[k]);
      se[k] = __fadd_rn(se[k], de);
      sey[k] = __fadd_rn(sey[k], __fmul_rn(yn, de));
    }
  }
  // slot p = threadIdx.x * V + k holds channel (base + p) % c
  float* se_s = smem;
  float* sey_s = smem + kThreads * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    se_s[threadIdx.x * V + k] = se[k];
    sey_s[threadIdx.x * V + k] = sey[k];
  }
  __syncthreads();
  const int span = kThreads * V;
  const int base = (int)(((int64_t)blockIdx.x * span) % c);
  float* row = partial + (int64_t)blockIdx.x * 2 * c;
  for (int cc = threadIdx.x; cc < c; cc += kThreads) {
    int p = cc - base;
    if (p < 0) p += c;
    float ae = 0.f, aey = 0.f;
    for (; p < span; p += c) {
      ae = __fadd_rn(ae, se_s[p]);
      aey = __fadd_rn(aey, sey_s[p]);
    }
    row[cc] = ae;
    row[c + cc] = aey;
  }
}

// ---- kernel 2, stage 2: reduce each of the 2c columns over the blocks ------
// Launch: 2c blocks of kThreads; sums[col] = sum_b partial[b][col].
__global__ void __launch_bounds__(kThreads)
abn_bwd_sums_final(const float* __restrict__ partial, int blocks, int c,
                   float* __restrict__ sums) {
  __shared__ float s[kThreads];
  const int col = blockIdx.x;
  float a = 0.f;
  for (int b = threadIdx.x; b < blocks; b += kThreads)
    a = __fadd_rn(a, partial[(int64_t)b * 2 * c + col]);
  s[threadIdx.x] = a;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] = __fadd_rn(s[threadIdx.x],
                                                    s[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[col] = s[0];
}

// ---- kernel 3: dx -----------------------------------------------------------
// Launch: blockDim.x == kThreads, gridDim.x * kThreads * V a multiple of c,
// n a multiple of V. sums is (2, c): edz then eydz.
template <typename T, int ACT, int V>
__global__ void __launch_bounds__(kThreads)
abn_bwd_dx_kernel(const T* __restrict__ y, const T* __restrict__ dz,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  const float* __restrict__ mul,
                  const float* __restrict__ sums, T* __restrict__ dx,
                  int64_t n, int c, float slope, float inv_n) {
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  float g[V], b[V], m[V], a[V], ey[V];
  int ch = (int)((tid * V) % c);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    g[k] = gamma[ch];
    b[k] = beta[ch];
    m[k] = mul[ch];
    a[k] = __fmul_rn(sums[ch], inv_n);  // edz * inv_n
    ey[k] = sums[c + ch];
    if (++ch == c) ch = 0;
  }
  const int64_t n_vec = n / V;
  for (int64_t iv = tid; iv < n_vec; iv += stride) {
    float yv[V], dv[V], out[V];
    load_vec<T, V>(y, iv, yv);
    load_vec<T, V>(dz, iv, dv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float z, de;
      act_invert<ACT>(yv[k], dv[k], slope, z, de);
      const float yn = __fdiv_rn(__fsub_rn(z, b[k]), g[k]);
      const float t = __fsub_rn(__fsub_rn(de, a[k]),
                                __fmul_rn(__fmul_rn(yn, ey[k]), inv_n));
      out[k] = __fmul_rn(t, m[k]);
    }
    store_vec<T, V>(dx, iv, out);
  }
}

// ---- launch helpers ---------------------------------------------------------

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = v > 0 ? v : 132;
  }
  return count[dev];
}

int64_t gcd(int64_t a, int64_t b) {
  while (b) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Elements per thread and iteration: 16 bytes when both inputs (and the
// output, if any) are 16-byte aligned and n is a multiple of the vector.
template <typename T>
int vector_width(const void* a, const void* b, const void* out, int64_t n) {
  constexpr int V = 16 / sizeof(T);
  const bool ok = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0 && n % V == 0;
  return ok ? V : 1;
}

// Blocks of kThreads for a grid-stride pass of n / v vectors, at most
// per_sm blocks per SM, with a stride (in elements) that is a multiple of c.
int64_t grid_blocks(int64_t n, int c, int v, int per_sm) {
  const int64_t work = n / v;
  const int64_t cap = (int64_t)sm_count() * per_sm;
  const int64_t step = c / gcd(c, (int64_t)kThreads * v);
  int64_t blocks = (work + kThreads - 1) / kThreads;
  blocks = (blocks + step - 1) / step * step;
  if (blocks > cap) blocks = cap >= step ? cap / step * step : step;
  return blocks;
}

template <typename T>
int64_t sums_blocks(const void* y, const void* dz, int64_t n, int c) {
  // the output pointer does not matter for kernel 2: pass y again
  return grid_blocks(n, c, vector_width<T>(y, dz, y, n), kSumsBlocksPerSm);
}

template <typename T, int ACT>
cudaError_t launch_sums(const void* y, const void* dz, const float* gamma,
                        const float* beta, float* workspace,
                        int64_t workspace_floats, float* sums, int64_t n,
                        int c, float slope, cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  const int v = vector_width<T>(y, dz, y, n);
  const int64_t blocks = grid_blocks(n, c, v, kSumsBlocksPerSm);
  if (blocks > 0x7fffffff || blocks * 2 * c > workspace_floats)
    return cudaErrorInvalidValue;
  const T* yt = static_cast<const T*>(y);
  const T* dt = static_cast<const T*>(dz);
  const size_t smem = 2 * kThreads * v * sizeof(float);
  if (v == VV) {
    abn_bwd_sums_partial<T, ACT, VV><<<(unsigned)blocks, kThreads, smem,
                                       stream>>>(yt, dt, gamma, beta,
                                                 workspace, n, c, slope);
  } else {
    abn_bwd_sums_partial<T, ACT, 1><<<(unsigned)blocks, kThreads, smem,
                                      stream>>>(yt, dt, gamma, beta,
                                                workspace, n, c, slope);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  abn_bwd_sums_final<<<(unsigned)(2 * c), kThreads, 0, stream>>>(
      workspace, (int)blocks, c, sums);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_dx(const void* y, const void* dz, const float* gamma,
                      const float* beta, const float* mul, const float* sums,
                      void* dx, int64_t n, int c, float slope, float inv_n,
                      cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  const int v = vector_width<T>(y, dz, dx, n);
  const int64_t blocks = grid_blocks(n, c, v, kDxBlocksPerSm);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const T* yt = static_cast<const T*>(y);
  const T* dt = static_cast<const T*>(dz);
  T* out = static_cast<T*>(dx);
  if (v == VV) {
    abn_bwd_dx_kernel<T, ACT, VV><<<(unsigned)blocks, kThreads, 0, stream>>>(
        yt, dt, gamma, beta, mul, sums, out, n, c, slope, inv_n);
  } else {
    abn_bwd_dx_kernel<T, ACT, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        yt, dt, gamma, beta, mul, sums, out, n, c, slope, inv_n);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t sums_act(int act, const void* y, const void* dz,
                     const float* gamma, const float* beta, float* workspace,
                     int64_t workspace_floats, float* sums, int64_t n, int c,
                     float slope, cudaStream_t s) {
  switch (act) {
    case kNone:
      return launch_sums<T, kNone>(y, dz, gamma, beta, workspace,
                                   workspace_floats, sums, n, c, slope, s);
    case kLeakyRelu:
      return launch_sums<T, kLeakyRelu>(y, dz, gamma, beta, workspace,
                                        workspace_floats, sums, n, c, slope,
                                        s);
    case kElu:
      return launch_sums<T, kElu>(y, dz, gamma, beta, workspace,
                                  workspace_floats, sums, n, c, slope, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dx_act(int act, const void* y, const void* dz, const float* gamma,
                   const float* beta, const float* mul, const float* sums,
                   void* dx, int64_t n, int c, float slope, float inv_n,
                   cudaStream_t s) {
  switch (act) {
    case kNone:
      return launch_dx<T, kNone>(y, dz, gamma, beta, mul, sums, dx, n, c,
                                 slope, inv_n, s);
    case kLeakyRelu:
      return launch_dx<T, kLeakyRelu>(y, dz, gamma, beta, mul, sums, dx, n,
                                      c, slope, inv_n, s);
    case kElu:
      return launch_dx<T, kElu>(y, dz, gamma, beta, mul, sums, dx, n, c,
                                slope, inv_n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of workspace that vae2_abn_bwd_sums needs for these arguments
// (0 for n == 0; -1 for arguments it refuses).
extern "C" long long vae2_abn_bwd_sums_workspace(const void* y, const void* dz,
                                                 long long n, int c,
                                                 int dtype) {
  if (n < 0 || c <= 0) return -1;
  if (n == 0) return 0;
  if (dtype == kBF16) return sums_blocks<__nv_bfloat16>(y, dz, n, c) * 2 * c;
  if (dtype == kF32) return sums_blocks<float>(y, dz, n, c) * 2 * c;
  return -1;
}

// sums (2, c) f32 <- [edz; eydz] of the (n / c, c) rows of y and dz.
extern "C" int vae2_abn_bwd_sums(const void* y, const void* dz,
                                 const void* gamma, const void* beta,
                                 void* workspace, long long workspace_floats,
                                 void* sums, long long n, int c, int dtype,
                                 int act, float slope, void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* ws = static_cast<float*>(workspace);
  float* out = static_cast<float*>(sums);
  cudaError_t err;
  if (dtype == kBF16) {
    err = sums_act<__nv_bfloat16>(act, y, dz, g, b, ws, workspace_floats, out,
                                  n, c, slope, s);
  } else if (dtype == kF32) {
    err = sums_act<float>(act, y, dz, g, b, ws, workspace_floats, out, n, c,
                          slope, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// dx (n / c, c) in y's dtype, from the sums of vae2_abn_bwd_sums.
extern "C" int vae2_abn_bwd_dx(const void* y, const void* dz,
                               const void* gamma, const void* beta,
                               const void* mul, const void* sums, void* dx,
                               long long n, int c, int dtype, int act,
                               float slope, float inv_n, void* stream) {
  if (n < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* m = static_cast<const float*>(mul);
  const float* sm = static_cast<const float*>(sums);
  cudaError_t err;
  if (dtype == kBF16) {
    err = dx_act<__nv_bfloat16>(act, y, dz, g, b, m, sm, dx, n, c, slope,
                                inv_n, s);
  } else if (dtype == kF32) {
    err = dx_act<float>(act, y, dz, g, b, m, sm, dx, n, c, slope, inv_n, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
