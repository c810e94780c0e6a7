// Flash attention, forward only, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`, called through
// `flash_attention` in src/repro/kernels/flash_attention.py, and computes the
// same function: softmax(scale * Q K^T + top-left causal mask) V with GQA
// (query head h reads kv head h / (Hq / Hkv)), kv tiles wholly above the
// diagonal skipped, fp32 running max, normaliser and accumulator, 0 for rows
// whose normaliser is 0, and the output in q's dtype. All dot products run in
// fp32 for both input types, as the Pallas kernel upcasts before each dot.
//
// What bounds it on this card. At the prefill shapes of the serving path
// (q 9 heads, k/v 3 heads, head dim 64, a few hundred tokens) the bytes that
// must move are q, k, v and o once each, a few MB, and the causal work is
// about 4 * D operations per visible (row, column) pair: in bf16 on the
// tensor cores the card could finish either in microseconds, and the bytes
// take longer, so the function is memory-bound. This kernel does its products
// with scalar fp32 FMAs on the CUDA cores (fp32 math, as the reference does),
// so it is bound in practice by those FMAs and by shared-memory loads, far
// above the memory bound. Tensor-core products (mma.sync / wgmma), TMA and a
// pipelined kv ring are later work.
//
// Design. The TPU kernel's grid is (B, Hq, q blocks, kv blocks) with the kv
// axis run in order and the softmax state carried in VMEM scratch between
// grid steps. CUDA blocks run in no order, so here one CTA owns one
// (b, hq, q tile) and loops over kv tiles up to the causal bound, keeping
// the running state in registers:
//   * 64 query rows per CTA and 64 kv rows per tile (of 32 and 64 in each,
//     the fastest at the serving shape);
//   * 4 warps; warp w owns BQ/4 query rows, lane l owns kv columns l, l+32
//     of a tile and head-dim columns l, l+32, ... of the accumulator, so row
//     max and row sum are warp shuffles and no state crosses warps;
//   * the q tile is staged once in shared memory as fp32; each kv tile is
//     staged as fp32 with K transposed and padded (conflict-free column
//     reads), V row-major; the probabilities of the tile go through shared
//     memory from the lanes that own columns to the lanes that own head dims;
//   * q and P are read as float4 broadcasts, so each shared-memory load
//     feeds four FMAs per row;
//   * the ragged edges of Sq and Sk are masked in the kernel (rows past Sq
//     are computed and not stored; columns past Sk score -1e30, as masked
//     columns do in the reference), so any prompt length runs;
//   * every tensor is addressed through element strides with a unit stride
//     on the head dim, so the caller passes (B, S, H, D) activations as
//     (B, H, S, D) views without a copy.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; bound through ctypes (a plain C interface).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // kv rows per staged tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kUnsupported = -1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, sequence
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int batch, hq, group, sq, sk, causal;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  // Qs[BQ][D] + Kt[D][BK + 1] + Vs[BK][D] + Ps[BQ][BK]
  return size_t(BQ) * D + size_t(D) * (BK + 1) + size_t(BK) * D + size_t(BQ) * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int ROWS = BQ / kWarps;   // query rows per warp
  constexpr int COLS = BK / 32;       // kv columns per lane
  constexpr int DJ = (D + 31) / 32;   // head-dim columns per lane
  static_assert(BQ % kWarps == 0 && BK % 32 == 0 && D % 4 == 0 && BK % 4 == 0, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ][D]
  float* Kt = Qs + BQ * D;          // [D][BK + 1], K transposed
  float* Vs = Kt + D * (BK + 1);    // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = q_start + r;
    Qs[idx] = row < p.sq ? to_float(qb[row * p.q_ss + c]) : 0.f;
  }

  const int row0 = warp * ROWS;
  float m[ROWS], l[ROWS], acc[ROWS][DJ];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // Tiles past the causal diagonal of this q tile hold no visible column.
  int n_tiles = (p.sk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q_start + BQ - 1) / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k_start = t * BK;
    __syncthreads();  // every warp is done with the previous tile (and Qs is written)
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, kr = k_start + r;
      float kx = 0.f, vx = 0.f;
      if (kr < p.sk) {
        kx = to_float(kb[kr * p.k_ss + c]);
        vx = to_float(vb[kr * p.v_ss + c]);
      }
      Kt[c * (BK + 1) + r] = kx;
      Vs[idx] = vx;
    }
    __syncthreads();

    // Scores for this warp's rows and this lane's columns.
    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int jc = 0; jc < COLS; ++jc) s[i][jc] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 4) {
      float kk[4][COLS];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int jc = 0; jc < COLS; ++jc) kk[u][jc] = Kt[(d0 + u) * (BK + 1) + lane + 32 * jc];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(&Qs[(row0 + i) * D + d0]);
#pragma unroll
        for (int jc = 0; jc < COLS; ++jc) {
          float a = s[i][jc];
          a = fmaf(q4.x, kk[0][jc], a);
          a = fmaf(q4.y, kk[1][jc], a);
          a = fmaf(q4.z, kk[2][jc], a);
          a = fmaf(q4.w, kk[3][jc], a);
          s[i][jc] = a;
        }
      }
    }

    // Online softmax, one row at a time across the warp.
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q_start + row0 + i;
      float x[COLS];
      float mt = kNegInf;
#pragma unroll
      for (int jc = 0; jc < COLS; ++jc) {
        const int col = k_start + lane + 32 * jc;
        const bool visible = col < p.sk && (!p.causal || col <= row);
        x[jc] = visible ? s[i][jc] * p.scale : kNegInf;
        mt = fmaxf(mt, x[jc]);
      }
      const float m_new = fmaxf(m[i], warp_max(mt));
      float psum = 0.f;
#pragma unroll
      for (int jc = 0; jc < COLS; ++jc) {
        const float pr = expf(x[jc] - m_new);
        Ps[(row0 + i) * BK + lane + 32 * jc] = pr;
        psum += pr;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // each warp reads back only its own rows of Ps

    // acc += P V for this warp's rows and this lane's head-dim columns.
#pragma unroll 2
    for (int c0 = 0; c0 < BK; c0 += 4) {
      float vv[4][DJ];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = lane + 32 * j;
          vv[u][j] = d < D ? Vs[(c0 + u) * D + d] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(&Ps[(row0 + i) * BK + c0]);
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          float a = acc[i][j];
          a = fmaf(p4.x, vv[0][j], a);
          a = fmaf(p4.y, vv[1][j], a);
          a = fmaf(p4.z, vv[2][j], a);
          a = fmaf(p4.w, vv[3][j], a);
          acc[i][j] = a;
        }
      }
    }
    __syncwarp();  // Ps is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q_start + row0 + i;
    if (row >= p.sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) ob[row * p.o_ss + d] = from_float<T>(acc[i][j] / safe_l);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = int(smem_floats<D>() * sizeof(float));
  // Above 48 KB a block needs the opt-in; set it on every call, it is cheap.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, p.batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return kUnsupported;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. strides: 12 element strides, (batch, head,
// sequence) for q, k, v and o in that order; the head dim has stride 1.
// Returns 0 on a successful launch, a cudaError_t code, or -1 for a dtype or
// head dim that is not compiled.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int batch, int hq, int hkv, int sq, int sk, int d,
                        const long long* strides, float scale, int causal, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.batch = batch;
  p.hq = hq;
  p.group = hq / hkv;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float>(p, d, st);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(p, d, st);
  return kUnsupported;
}

const char* flash_attention_error_string(int code) {
  if (code == kUnsupported) return "dtype or head dim not compiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
