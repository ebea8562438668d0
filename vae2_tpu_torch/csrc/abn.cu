// Fused BatchNorm + activation for Hopper (sm_90a), with the BN fold inside.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, launched by `_abn_rows`
// (vae2_tpu/ops/pallas/abn.py:86-113), together with the fold that its
// callers run before it (abn.py:123-125 for inference, :247-249 for
// training): y = act(x * mul + add) per channel over a channels-last buffer
// of R = N*H*W rows by C channels, computed in f32 and stored in x's dtype.
// Activations: none, leaky_relu(slope), elu.
//
// Two entries into one kernel:
// - vae2_abn_fwd_fold (the main path): x and the f32 (C,) vectors mean,
//   var, gamma, beta. Each thread folds its channels in its prologue, in the
//   JAX package's order and rounding: inv = rsqrt(var + eps);
//   mul = (inv * gamma) and add = (beta - mean * inv * gamma), both cast to
//   x's dtype and read back in f32 (abn.py:90-92). With `gamma_inv`
//   non-null (the training forward) the first block also writes the f32
//   (C,) vector gamma * inv that the backward's dx kernel takes as `mul`
//   (abn.py:208). rsqrtf is the function PyTorch's CUDA `rsqrt` calls, so
//   the fold gives the plain version's bits.
// - vae2_abn_fwd: x and (mul, add) already folded, in x's dtype.
//
// What bounds it: bytes. Each element is read once and written once
// (2 * R * C * sizeof(T) bytes) and costs two flops, far below the card's
// rate of operations per byte, so the least time is the bytes over the
// 3.35 TB/s of HBM. For the small tensors of the path the floor is the cost
// of a call, so the fold is not a few kernels of its own but a prologue.
//
// What the design does about it: the work is one flat elementwise pass
// with c = i % C, not the TPU's 256-row tiles. Each thread moves 16 bytes
// per load and per store (8 bf16 or 4 f32 values) when both buffers are
// 16-byte aligned, in a grid-stride loop over a few blocks per SM. The
// launch makes the grid's stride a multiple of C elements, so each thread
// meets the same V channels on every iteration: it folds their (mul, add)
// once into registers, and the loop body is a load, V multiply-adds and a
// store, with no table lookups and no modulo. The fold reads the four
// statistics of its V channels 4 (or 2) at a time when C and the vectors'
// alignment allow it: a warp's lanes meet up to 8 cache lines of each
// vector at C 256, and with one load per channel the prologue's L1 traffic
// cost more than the pass itself at the path's mid-sized shapes, where each
// thread meets only one or two vectors of x. The ragged tail, and
// buffers that are not 16-byte aligned, go element by element. The
// multiply and the add are rounded separately (__fmul_rn, __fadd_rn), as
// PyTorch's plain version rounds them, so that both give the same bits for
// act none and leaky_relu, and for elu, whose exp(z) - 1 both take in f64
// and round once.
//
// Interface: plain C, for ctypes. Each entry returns cudaGetLastError()
// after its one launch; the kernel runs on the caller's stream and
// allocates nothing.

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
  // elu: exp(z) - 1 in f64, rounded once to f32, as the plain version
  // computes it (the subtraction in f64 also keeps the compiler from
  // narrowing the f64 exp to expf). An f32 expf may differ from the host's
  // by an ulp, and the backward inverts elu from y through log(1 + y),
  // which turns one ulp of y near -1 into ~1e-4 of dx.
  if (ACT == kElu)
    return z >= 0.f ? z : (float)(exp((double)fminf(z, 0.f)) - 1.0);
  return z;
}

template <typename T, int ACT>
__device__ __forceinline__ T abn_one(float v, float m, float a, float slope) {
  return store_as<T>(act_apply<ACT>(__fadd_rn(__fmul_rn(v, m), a), slope));
}

// The per-channel values: either folded from the BN statistics (mean
// non-null) or read from (mul, add).
template <typename T>
struct Channels {
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  const T* mul;
  const T* add;
  float eps;
  int width;  // floats per load of the statistics: 4, 2 or 1

  __device__ __forceinline__ float gamma_inv(int ch) const {
    return __fmul_rn(rsqrtf(__fadd_rn(var[ch], eps)), gamma[ch]);
  }

  // (mul, add) of one channel from its statistics, in x's dtype, read back
  // in f32
  __device__ __forceinline__ void fold(float mu, float va, float g, float b,
                                       float& m, float& a) const {
    const float inv = rsqrtf(__fadd_rn(va, eps));
    m = load_f32(store_as<T>(__fmul_rn(inv, g)));
    a = load_f32(store_as<T>(__fsub_rn(b, __fmul_rn(__fmul_rn(mu, inv), g))));
  }

  // (mul, add) of channel ch
  __device__ __forceinline__ void get(int ch, float& m, float& a) const {
    if (mean == nullptr) {
      m = load_f32(mul[ch]);
      a = load_f32(add[ch]);
      return;
    }
    fold(mean[ch], var[ch], gamma[ch], beta[ch], m, a);
  }

  // (mul, add) of the V channels ch0, ch0 + 1, ... (mod c)
  template <int V>
  __device__ __forceinline__ void get_all(int ch0, int c, float (&m)[V],
                                          float (&a)[V]) const {
    if (mean != nullptr && width == 4) {
      fold_wide<V, 4>(ch0, c, m, a);
    } else if (mean != nullptr && width == 2) {
      fold_wide<V, 2>(ch0, c, m, a);
    } else {
      int ch = ch0;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        get(ch, m[k], a[k]);
        if (++ch == c) ch = 0;
      }
    }
  }

  // W channels per load: c and ch0 are multiples of W, so no load wraps
  template <int V, int W>
  __device__ __forceinline__ void fold_wide(int ch0, int c, float (&m)[V],
                                            float (&a)[V]) const {
#pragma unroll
    for (int q = 0; q < V; q += W) {
      const int ch = (ch0 + q) % c;
      float mu[W], va[W], g[W], b[W];
      load_w<W>(mean + ch, mu);
      load_w<W>(var + ch, va);
      load_w<W>(gamma + ch, g);
      load_w<W>(beta + ch, b);
#pragma unroll
      for (int k = 0; k < W; ++k) fold(mu[k], va[k], g[k], b[k], m[q + k],
                                       a[q + k]);
    }
  }

  template <int W>
  __device__ __forceinline__ static void load_w(const float* p,
                                                float (&out)[W]) {
    if constexpr (W == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[0] = v.x, out[1] = v.y;
    }
  }
};

// vectorized: x and y 16-byte aligned, and gridDim.x * blockDim.x * V a
// multiple of c (the launch sees to both).
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
abn_fwd_kernel(const T* __restrict__ x, Channels<T> chan, T* __restrict__ y,
               float* __restrict__ gamma_inv, int64_t n, int c, float slope,
               bool vectorized) {
  constexpr int V = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gamma_inv != nullptr && blockIdx.x == 0) {
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x)
      gamma_inv[ch] = chan.gamma_inv(ch);
  }
  int64_t done = 0;
  if (vectorized) {
    union Pack {
      uint4 u;
      T v[V];
    };
    const int64_t n_vec = n / V;
    Pack in;  // the first load is in flight while the channels fold
    if (tid < n_vec) in.u = reinterpret_cast<const uint4*>(x)[tid];
    float m[V], a[V];
    chan.template get_all<V>((int)((tid * V) % c), c, m, a);
    for (int64_t iv = tid; iv < n_vec; iv += stride) {
      Pack out;
      if (iv != tid) in.u = reinterpret_cast<const uint4*>(x)[iv];
#pragma unroll
      for (int k = 0; k < V; ++k)
        out.v[k] = abn_one<T, ACT>(load_f32(in.v[k]), m[k], a[k], slope);
      reinterpret_cast<uint4*>(y)[iv] = out.u;
    }
    done = n_vec * V;
  }
  // the ragged tail, or everything when the buffers are not aligned
  for (int64_t i = done + tid; i < n; i += stride) {
    float m, a;
    chan.get((int)(i % c), m, a);
    y[i] = abn_one<T, ACT>(load_f32(x[i]), m, a, slope);
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
cudaError_t launch(const void* x, const Channels<T>& chan, void* y,
                   float* gamma_inv, int64_t n, int c, float slope,
                   cudaStream_t stream) {
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
  if (blocks < 1) blocks = 1;  // n == 0: the first block still writes gamma_inv
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  abn_fwd_kernel<T, ACT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), chan, static_cast<T*>(y), gamma_inv, n, c,
      slope, vectorized);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_act(int act, const void* x, const Channels<T>& chan,
                         void* y, float* gamma_inv, int64_t n, int c,
                         float slope, cudaStream_t stream) {
  switch (act) {
    case kNone:
      return launch<T, kNone>(x, chan, y, gamma_inv, n, c, slope, stream);
    case kLeakyRelu:
      return launch<T, kLeakyRelu>(x, chan, y, gamma_inv, n, c, slope,
                                   stream);
    case kElu:
      return launch<T, kElu>(x, chan, y, gamma_inv, n, c, slope, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The statistics are read 4 floats at a time when C is a multiple of 4 and
// all four vectors are 16-byte aligned, 2 when C is even and they are
// 8-byte aligned, else one by one.
template <typename T>
Channels<T> channels(const void* mean, const void* var, const void* gamma,
                     const void* beta, const void* mul, const void* add,
                     float eps, int c) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(mean) |
                        reinterpret_cast<uintptr_t>(var) |
                        reinterpret_cast<uintptr_t>(gamma) |
                        reinterpret_cast<uintptr_t>(beta);
  const int width = c % 4 == 0 && any % 16 == 0 ? 4
                    : c % 2 == 0 && any % 8 == 0 ? 2 : 1;
  return {static_cast<const float*>(mean), static_cast<const float*>(var),
          static_cast<const float*>(gamma), static_cast<const float*>(beta),
          static_cast<const T*>(mul), static_cast<const T*>(add), eps, width};
}

int run(const void* x, const void* mean, const void* var, const void* gamma,
        const void* beta, const void* mul, const void* add, void* y,
        void* gamma_inv, long long n, int c, int dtype, int act, float eps,
        float slope, void* stream) {
  if (n < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0 && gamma_inv == nullptr) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gi = static_cast<float*>(gamma_inv);
  cudaError_t err;
  if (dtype == kBF16) {
    err = dispatch_act<__nv_bfloat16>(
        act, x, channels<__nv_bfloat16>(mean, var, gamma, beta, mul, add, eps,
                                      c),
        y, gi, n, c, slope, s);
  } else if (dtype == kF32) {
    err = dispatch_act<float>(
        act, x, channels<float>(mean, var, gamma, beta, mul, add, eps, c), y, gi,
        n, c, slope, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// y = act(x * mul + add) with (mul, add) folded from the f32 BN statistics
// and affine parameters; gamma_inv (f32, (C,)) may be null.
extern "C" int vae2_abn_fwd_fold(const void* x, const void* mean,
                                 const void* var, const void* gamma,
                                 const void* beta, void* y, void* gamma_inv,
                                 long long n, int c, int dtype, int act,
                                 float eps, float slope, void* stream) {
  if (mean == nullptr || var == nullptr || gamma == nullptr ||
      beta == nullptr)
    return (int)cudaErrorInvalidValue;
  return run(x, mean, var, gamma, beta, nullptr, nullptr, y, gamma_inv, n, c,
             dtype, act, eps, slope, stream);
}

// y = act(x * mul + add) with (mul, add) given in x's dtype.
extern "C" int vae2_abn_fwd(const void* x, const void* mul, const void* add,
                            void* y, long long n, int c, int dtype, int act,
                            float slope, void* stream) {
  if (mul == nullptr || add == nullptr) return (int)cudaErrorInvalidValue;
  return run(x, nullptr, nullptr, nullptr, nullptr, mul, add, y, nullptr, n,
             c, dtype, act, 0.f, slope, stream);
}
