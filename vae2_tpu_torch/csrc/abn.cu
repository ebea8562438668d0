// Fused inference BatchNorm + activation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, launched by `_abn_rows`
// (vae2_tpu/ops/pallas/abn.py:86-113): y = act(x * mul + add) per channel
// over a channels-last buffer of R = N*H*W rows by C channels, computed in
// f32 and stored in x's dtype. `mul` and `add` are the folded BN
// (running mean, var, gamma, beta) in x's dtype; they are read in f32, as
// at abn.py:90-92. Activations: none, leaky_relu(slope), elu.
//
// What bounds it: bytes. Each element is read once and written once
// (2 * R * C * sizeof(T) bytes) and costs two flops, far below the card's
// rate of operations per byte, so the least time is the bytes over the
// 3.35 TB/s of HBM.
//
// What the design does about it: the work is one flat elementwise pass
// with c = i % C, not the TPU's 256-row tiles. Each thread moves 16 bytes
// per load and per store (8 bf16 or 4 f32 values) when both buffers are
// 16-byte aligned, in a grid-stride loop over a few blocks per SM. The
// launch makes the grid's stride a multiple of C elements, so each thread
// meets the same V channels on every iteration: it reads their (mul, add)
// once into registers, and the loop body is a load, V multiply-adds and a
// store, with no table lookups and no modulo. The ragged tail, and
// buffers that are not 16-byte aligned, go element by element. The
// multiply and the add are rounded separately (__fmul_rn, __fadd_rn), as
// PyTorch's plain version rounds them, so that both give the same bits for
// act none and leaky_relu.
//
// Interface: plain C, for ctypes. vae2_abn_fwd returns cudaGetLastError()
// after the launch; the kernel runs on the caller's stream and allocates
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

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

template <int ACT>
__device__ __forceinline__ float act_apply(float z, float slope) {
  if (ACT == kLeakyRelu) return z >= 0.f ? z : __fmul_rn(z, slope);
  if (ACT == kElu) return z >= 0.f ? z : expf(fminf(z, 0.f)) - 1.f;
  return z;
}

template <typename T, int ACT>
__device__ __forceinline__ T abn_one(float v, float m, float a, float slope) {
  return store_as<T>(act_apply<ACT>(__fadd_rn(__fmul_rn(v, m), a), slope));
}

// vectorized: x and y 16-byte aligned, and gridDim.x * blockDim.x * V a
// multiple of c (the launch sees to both).
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
abn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ mul,
               const T* __restrict__ add, T* __restrict__ y, int64_t n,
               int c, float slope, bool vectorized) {
  constexpr int V = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vectorized) {
    float m[V], a[V];
    int ch = (int)((tid * V) % c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = load_f32(mul[ch]);
      a[k] = load_f32(add[ch]);
      if (++ch == c) ch = 0;
    }
    union Pack {
      uint4 u;
      T v[V];
    };
    const int64_t n_vec = n / V;
    for (int64_t iv = tid; iv < n_vec; iv += stride) {
      Pack in, out;
      in.u = reinterpret_cast<const uint4*>(x)[iv];
#pragma unroll
      for (int k = 0; k < V; ++k)
        out.v[k] = abn_one<T, ACT>(load_f32(in.v[k]), m[k], a[k], slope);
      reinterpret_cast<uint4*>(y)[iv] = out.u;
    }
    done = n_vec * V;
  }
  // the ragged tail, or everything when the buffers are not aligned
  for (int64_t i = done + tid; i < n; i += stride) {
    const int ch = (int)(i % c);
    y[i] = abn_one<T, ACT>(load_f32(x[i]), load_f32(mul[ch]),
                           load_f32(add[ch]), slope);
  }
}

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

template <typename T, int ACT>
cudaError_t launch(const void* x, const void* mul, const void* add, void* y,
                   int64_t n, int c, float slope, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vectorized = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                          (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                          n >= V;
  const int64_t work = vectorized ? n / V : n;
  const int64_t cap = (int64_t)sm_count() * kBlocksPerSm;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (vectorized) {
    // the grid's stride in elements must be a multiple of c
    const int64_t step = c / gcd(c, (int64_t)kThreads * V);
    blocks = (blocks + step - 1) / step * step;
    if (blocks > cap) blocks = cap >= step ? cap / step * step : step;
  } else if (blocks > cap) {
    blocks = cap;
  }
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  abn_fwd_kernel<T, ACT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mul),
      static_cast<const T*>(add), static_cast<T*>(y), n, c, slope,
      vectorized);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_act(int act, const void* x, const void* mul,
                         const void* add, void* y, int64_t n, int c,
                         float slope, cudaStream_t stream) {
  switch (act) {
    case kNone:
      return launch<T, kNone>(x, mul, add, y, n, c, slope, stream);
    case kLeakyRelu:
      return launch<T, kLeakyRelu>(x, mul, add, y, n, c, slope, stream);
    case kElu:
      return launch<T, kElu>(x, mul, add, y, n, c, slope, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vae2_abn_fwd(const void* x, const void* mul, const void* add,
                            void* y, long long n, int c, int dtype, int act,
                            float slope, void* stream) {
  if (n < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBF16) {
    err = dispatch_act<__nv_bfloat16>(act, x, mul, add, y, n, c, slope, s);
  } else if (dtype == kF32) {
    err = dispatch_act<float>(act, x, mul, add, y, n, c, slope, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
