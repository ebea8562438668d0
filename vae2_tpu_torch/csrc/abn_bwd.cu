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
// Kernel 2 is ONE launch and DETERMINISTIC: the same inputs give the same
// bits on every run. Each thread keeps f32 partial sums of its V channels
// in registers; at the end the block writes them to shared memory and sums
// each channel's slots in a fixed order into its row of a (blocks, 2, C)
// partials buffer. Each block then fences its writes and draws a ticket
// from a counter (atomicInc with limit gridDim.x - 1, so the counter wraps
// back to 0 by itself at the last ticket and needs no reset). The block
// that draws the last ticket reduces each of the 2*C columns over the
// blocks in block order (block groups in a fixed layout, then the groups
// in order), reading the partials through L2 (__ldcg), and writes the
// sums. The ticket is the only atomic, so the bits do not depend on which
// block finished last. (The Pallas kernel accumulates in grid order and is
// deterministic too.) For the small tensors of the path, whose bound is
// under a microsecond, one launch instead of two is what the design buys;
// for the large ones the last block's pass over the partials (blocks * 2C
// floats from L2) is the price, which the grid's size bounds: at 2 blocks
// per SM (264) it is 540 KB at C = 256. (Two levels of tickets, groups of 16
// blocks reduced by their last block and the group rows by the last group,
// shortened that pass but cost a second fence and atomic, ~2.5 us, at every
// shape of more than 16 blocks: slower over a train step, not kept.)
//
// Interface: plain C, for ctypes. Each launcher makes one launch on the
// caller's stream and returns cudaGetLastError() after it; neither
// allocates. vae2_abn_bwd_sums takes a scratch buffer (the counter, zeroed
// once by its owner, then the partials) that the caller keeps from call to
// call on one stream; when it is too small, it launches nothing and returns
// minus the floats it needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kDxBlocksPerSm = 8;
constexpr int kCounterFloats = 4;  // the ticket counter, then the partials

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

// ---- kernel 2, a ticket's last block: each column over the rows, in order -
// sums[col] = sum over b < blocks of partial[b][col], for cols = 2c columns
// of rows that other blocks wrote, read through L2 as units of VW floats
// (VW = 4: 16-byte loads, when cols % 4 == 0). The threads form `groups`
// groups of w (one unit each per pass); group g adds the rows g, g +
// groups, g + 2 * groups, ... in that order, eight loads in flight, and the
// groups' results are added in group order. The layout depends on cols
// only, so the order is the same on every run. `red` holds kThreads * VW
// floats.
template <int VW>
__device__ __forceinline__ void reduce_columns(const float* partial,
                                               int blocks, int cols,
                                               float* __restrict__ sums,
                                               float* red) {
  using Unit = typename std::conditional<VW == 4, float4, float>::type;
  const int units = cols / VW;
  const int w = units < kThreads ? units : kThreads;  // units per pass
  const int groups = kThreads / w;
  const int g = threadIdx.x / w, j = threadIdx.x % w;
  for (int u0 = 0; u0 < units; u0 += w) {
    const int u = u0 + j;
    float acc[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[i] = 0.f;
    if (g < groups && u < units) {
      const Unit* p = reinterpret_cast<const Unit*>(partial) + u;
      int b = g;
      for (; b + 7 * groups < blocks; b += 8 * groups) {
        Unit v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = __ldcg(p + (int64_t)(b + k * groups) * units);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float* f = reinterpret_cast<const float*>(&v[k]);
#pragma unroll
          for (int i = 0; i < VW; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
        }
      }
      for (; b < blocks; b += groups) {
        const Unit v = __ldcg(p + (int64_t)b * units);
        const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VW; ++i) red[threadIdx.x * VW + i] = acc[i];
    __syncthreads();
    if (g == 0 && u < units) {
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        float s = red[j * VW + i];
        for (int k = 1; k < groups; ++k)
          s = __fadd_rn(s, red[(k * w + j) * VW + i]);
        sums[u * VW + i] = s;
      }
    }
    __syncthreads();
  }
}

// The rows [0, rows) of cols floats at `in`, reduced in order into `out`
// (cols floats), by the whole block.
__device__ __forceinline__ void reduce_rows(const float* in, int rows,
                                            int cols, float* out,
                                            float* red) {
  if (cols % 4 == 0)  // rows of 16-byte multiples (c even)
    reduce_columns<4>(in, rows, cols, out, red);
  else
    reduce_columns<1>(in, rows, cols, out, red);
}

// Thread 0 draws a ticket from `counter` for the block (after every thread
// has fenced its writes); true in every thread of the block that draws the
// last of `tickets`.
__device__ __forceinline__ bool last_ticket(unsigned* counter,
                                            unsigned tickets) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicInc(counter, tickets - 1) == tickets - 1;
    if (last) __threadfence();  // the others' rows before ours are read
  }
  __syncthreads();
  return last;
}

// ---- kernel 2: per-block partial sums, then the last block's reduction ---
// Launch: blockDim.x == kThreads, gridDim.x * kThreads * V a multiple of c,
// n a multiple of V, dynamic shared memory 2 * kThreads * (V + 1) floats;
// `counter` is 0 before the launch (and is 0 again after it), `partial`
// holds gridDim.x * 2c floats.
template <typename T, int ACT, int V>
__global__ void __launch_bounds__(kThreads)
abn_bwd_sums_kernel(const T* __restrict__ y, const T* __restrict__ dz,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, unsigned* counter,
                    float* partial, float* __restrict__ sums, int64_t n,
                    int c, float slope) {
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
  // two iterations' loads in flight at a time, added in iteration order
  const int64_t n_vec = n / V;
  int64_t iv = tid;
  for (; iv < n_vec; iv += 2 * stride) {
    const bool second = iv + stride < n_vec;
    float yv[2][V], dv[2][V];
    load_vec<T, V>(y, iv, yv[0]);
    load_vec<T, V>(dz, iv, dv[0]);
    if (second) {
      load_vec<T, V>(y, iv + stride, yv[1]);
      load_vec<T, V>(dz, iv + stride, dv[1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !second) break;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float z, de;
        act_invert<ACT>(yv[u][k], dv[u][k], slope, z, de);
        const float yn = __fdiv_rn(__fsub_rn(z, b[k]), g[k]);
        se[k] = __fadd_rn(se[k], de);
        sey[k] = __fadd_rn(sey[k], __fmul_rn(yn, de));
      }
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
  // channel cc's slots are p0 + i * c, p0 = (cc - base) mod c; `groups`
  // threads add them in a fixed layout (group g takes i = g, g + groups,
  // ...), then the first adds the groups' results in group order
  const int span = kThreads * V;
  const int base = (int)(((int64_t)blockIdx.x * span) % c);
  float* row = partial + (int64_t)blockIdx.x * 2 * c;
  float* red_e = smem + 2 * span;
  float* red_ey = red_e + kThreads;
  const int w = c < kThreads ? c : kThreads;
  const int groups = kThreads / w;
  const int gi = threadIdx.x / w, j = threadIdx.x % w;
  for (int cc0 = 0; cc0 < c; cc0 += w) {
    const int cc = cc0 + j;
    float ae = 0.f, aey = 0.f;
    if (gi < groups && cc < c) {
      int p = cc - base;
      if (p < 0) p += c;
      for (p += gi * c; p < span; p += groups * c) {
        ae = __fadd_rn(ae, se_s[p]);
        aey = __fadd_rn(aey, sey_s[p]);
      }
    }
    red_e[threadIdx.x] = ae;
    red_ey[threadIdx.x] = aey;
    __syncthreads();
    if (gi == 0 && cc < c) {
      for (int k = 1; k < groups; ++k) {
        ae = __fadd_rn(ae, red_e[k * w + j]);
        aey = __fadd_rn(aey, red_ey[k * w + j]);
      }
      row[cc] = ae;
      row[c + cc] = aey;
    }
    __syncthreads();
  }
  // publish the row, then draw a ticket; the last block reduces the rows
  if (!last_ticket(counter, gridDim.x)) return;
  reduce_rows(partial, (int)gridDim.x, 2 * c, sums, smem);
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
// per_sm blocks per SM and no more than give each thread `min_iters`
// vectors, with a stride (in elements) that is a multiple of c.
int64_t grid_blocks(int64_t n, int c, int v, int per_sm, int min_iters) {
  const int64_t work = n / v;
  const int64_t cap = (int64_t)sm_count() * per_sm;
  const int64_t step = c / gcd(c, (int64_t)kThreads * v);
  const int64_t per_block = (int64_t)kThreads * min_iters;
  int64_t blocks = (work + per_block - 1) / per_block;
  blocks = (blocks + step - 1) / step * step;
  if (blocks > cap) blocks = cap >= step ? cap / step * step : step;
  return blocks;
}

// 0 after the launch, a CUDA error (> 0), or minus the floats of scratch
// that these arguments need when `scratch_floats` is fewer (no launch).
template <typename T, int ACT>
long long launch_sums(const void* y, const void* dz, const float* gamma,
                      const float* beta, float* scratch,
                      int64_t scratch_floats, float* sums, int64_t n, int c,
                      float slope, int per_sm, int min_iters,
                      cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  // the output pointer does not matter for kernel 2: pass y again
  const int v = vector_width<T>(y, dz, y, n);
  const int64_t blocks = grid_blocks(n, c, v, per_sm, min_iters);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int64_t need = kCounterFloats + blocks * 2 * c;
  if (need > scratch_floats) return -need;
  unsigned* counter = reinterpret_cast<unsigned*>(scratch);
  float* partial = scratch + kCounterFloats;
  const T* yt = static_cast<const T*>(y);
  const T* dt = static_cast<const T*>(dz);
  const size_t smem = 2 * kThreads * (v + 1) * sizeof(float);
  if (v == VV) {
    abn_bwd_sums_kernel<T, ACT, VV><<<(unsigned)blocks, kThreads, smem,
                                      stream>>>(yt, dt, gamma, beta, counter,
                                                partial, sums, n, c, slope);
  } else {
    abn_bwd_sums_kernel<T, ACT, 1><<<(unsigned)blocks, kThreads, smem,
                                     stream>>>(yt, dt, gamma, beta, counter,
                                               partial, sums, n, c, slope);
  }
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_dx(const void* y, const void* dz, const float* gamma,
                      const float* beta, const float* mul, const float* sums,
                      void* dx, int64_t n, int c, float slope, float inv_n,
                      cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  const int v = vector_width<T>(y, dz, dx, n);
  const int64_t blocks = grid_blocks(n, c, v, kDxBlocksPerSm, 1);
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
long long sums_act(int act, const void* y, const void* dz, const float* gamma,
                   const float* beta, float* scratch, int64_t scratch_floats,
                   float* sums, int64_t n, int c, float slope, int per_sm,
                   int min_iters, cudaStream_t s) {
  switch (act) {
    case kNone:
      return launch_sums<T, kNone>(y, dz, gamma, beta, scratch,
                                   scratch_floats, sums, n, c, slope, per_sm,
                                   min_iters, s);
    case kLeakyRelu:
      return launch_sums<T, kLeakyRelu>(y, dz, gamma, beta, scratch,
                                        scratch_floats, sums, n, c, slope,
                                        per_sm, min_iters, s);
    case kElu:
      return launch_sums<T, kElu>(y, dz, gamma, beta, scratch,
                                  scratch_floats, sums, n, c, slope, per_sm,
                                  min_iters, s);
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

// sums (2, c) f32 <- [edz; eydz] of the (n / c, c) rows of y and dz, in
// one launch of at most `blocks_per_sm` blocks per SM, and no more blocks
// than give each thread `min_iters` vectors of 16 bytes. `scratch` holds
// `scratch_floats` floats, its first word a counter that is 0 (zero it once
// when the buffer is made; every completed launch leaves it 0); keep one
// scratch per stream. Returns 0 after the launch, a CUDA error (> 0), or
// minus the floats of scratch needed when there are fewer (no launch).
extern "C" long long vae2_abn_bwd_sums(const void* y, const void* dz,
                                       const void* gamma, const void* beta,
                                       void* scratch,
                                       long long scratch_floats, void* sums,
                                       long long n, int c, int dtype, int act,
                                       float slope, int blocks_per_sm,
                                       int min_iters, void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0 || blocks_per_sm <= 0 || min_iters <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* scr = static_cast<float*>(scratch);
  float* out = static_cast<float*>(sums);
  if (dtype == kBF16)
    return sums_act<__nv_bfloat16>(act, y, dz, g, b, scr, scratch_floats, out,
                                   n, c, slope, blocks_per_sm, min_iters, s);
  if (dtype == kF32)
    return sums_act<float>(act, y, dz, g, b, scr, scratch_floats, out, n, c,
                           slope, blocks_per_sm, min_iters, s);
  return cudaErrorInvalidValue;
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
