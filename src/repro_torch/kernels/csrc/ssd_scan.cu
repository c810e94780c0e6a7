// Mamba-2 SSD chunked scan, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan.py:35),
// called through `ssd_scan` in the same file, and computes the same function.
// Per (batch b, head h) the chunks of Q positions run in order, with the
// state h (P x N, fp32) carried from one chunk to the next. In each chunk:
//   acs    = cumsum(dt_a)                                  (Q,)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(acs_i - acs_j) X_j
//          + exp(acs_i) (C_i h^T)                           (Q, P)
//   h      = exp(acs_last) h + sum_j X_j^T B_j exp(acs_last - acs_j)
// B and C of head h are those of group h / (H / G). All math is fp32, for
// both input types, as the Pallas kernel upcasts before each product; y is
// written in x's dtype and the final state in fp32. The initial state is
// optional (zeros when absent).
//
// What bounds it on this card. At the serving shape (B 8, S 512, H 64,
// P 64, N 128, G 1, Q 256, bf16) the bytes that must move are x and y
// (67 MB), the entering and final states (34 MB) and dt_a, B and C (3 MB):
// about 0.031 ms at 3.35 TB/s. The visible work, 2 (N + P) per (i >= j)
// pair plus 4 N P per position, is 21.5 GFLOP: 0.022 ms on the bf16 tensor
// cores. So the function is memory-bound. This kernel does its products with
// scalar fp32 FMAs on the CUDA cores (about 12 G FMAs at that shape, with
// whole 64 x 64 tiles on the diagonal), and is bound in practice by those
// FMAs and the shared-memory loads that feed them, far above the memory
// bound. Tensor cores (mma.sync / wgmma), TMA, an in-kernel ragged tail and
// a chunk-parallel split for small B*H are later work.
//
// Design. The TPU kernel's grid is (B, H, chunks) with the chunk axis run in
// order and h carried in VMEM scratch; it holds a whole Q = 256 chunk at once
// (x 64 KB, B and C 128 KB each, L 256 KB in fp32). CUDA blocks run in no
// order and a block has at most 227 KB of shared memory, so here:
//   * one CTA of 8 warps owns one (b, h) and loops over its chunks in order,
//     h in shared memory as h^T (N rows of P + 1 floats: odd stride, so
//     both the row reads and the column writes are free of bank conflicts);
//   * acs for the whole chunk (Q floats) is a block-wide inclusive scan of
//     dt_a, and exp(acs_last - acs) is kept beside it;
//   * the chunk is walked in 64-row tiles i, as flash attention walks query
//     tiles: C_i is staged once, y_i starts as exp(acs) (C_i h^T) from the
//     entering state, then key tiles j <= i are staged (B_j transposed and
//     padded, X_j row-major) and y_i += S_ij X_j with the score
//     S = (C_i B_j^T) exp(acs_i - acs_j) and no softmax. Warp w owns 8 rows,
//     lane l owns key columns l, l + 32 and head-dim columns l, l + 32, ...;
//     the scores pass through shared memory read back by the same warp;
//   * the triangular mask is a select, never a product with 0: above the
//     diagonal exp(acs_i - acs_j) grows with the chunk and inf * 0 is NaN;
//   * the last row tile visits every key tile, so it also accumulates the
//     state update X^T (B exp(acs_last - acs)) in registers (lane l owns
//     state rows l, l + 32, ...; warp w owns P / 8 head-dim columns);
//     h is overwritten only after a barrier that follows every row tile's
//     read of the entering state;
//   * rows and columns past Q in a tile are zeros and masked, so any chunk
//     length up to 1024 runs; S must be a multiple of Q (the caller pads);
//   * every input is addressed through element strides with a unit stride
//     on its last dim; y is written through strides, the final state is a
//     contiguous (B, H, P, N) fp32 tensor.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; bound through ctypes (a plain C interface).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int BR = 64;          // chunk rows per row tile
constexpr int BC = 64;          // chunk rows per key tile
constexpr int kMaxState = 128;  // N
constexpr int kMaxChunk = 1024;  // Q
constexpr int kUnsupported = -1;

struct Params {
  const void* x;
  const float* dt_a;
  const void* b;
  const void* c;
  const float* init;  // may be null: zeros
  void* y;
  float* final_state;
  long long x_sb, x_ss, x_sh;  // element strides: batch, sequence, head
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss, b_sg;  // batch, sequence, group
  long long c_sb, c_ss, c_sg;
  long long i_sb, i_sh, i_sp;  // batch, head, head dim
  long long y_sb, y_ss, y_sh;
  int heads, rep, seqlen, n, chunk;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Shared-memory layout, in floats; every array starts on a 16-byte boundary.
struct Layout {
  int ht, cs, bt, xs, ps, acs, dec, tot, total;
  __host__ __device__ Layout(int p, int n, int q) {
    ht = 0;                                  // h^T: [N][P + 1]
    cs = ht + round4(n * (p + 1));           // C tile: [BR][N]
    bt = cs + BR * n;                        // B tile transposed: [N][BC + 1]
    xs = bt + round4(n * (BC + 1));          // X tile: [BC][P]
    ps = xs + BC * p;                        // scores: [BR][BC]
    acs = ps + BR * BC;                      // cumsum of dt_a: [Q]
    dec = acs + round4(q);                   // exp(acs_last - acs): [Q]
    tot = dec + round4(q);                   // per-warp scan totals: [kWarps]
    total = tot + kWarps;
  }
};

// acs[q] = dt_a[0] + ... + dt_a[q] for q < Q (Q <= 4 * kThreads): each thread
// sums up to four consecutive entries, then a warp scan and a scan of the
// warp totals give every thread its prefix.
__device__ void chunk_cumsum(const float* a, long long a_ss, int q_len, float* acs, float* tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (q_len + kThreads - 1) / kThreads;
  const int q0 = tid * per;
  float local[4];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < per && q0 + e < q_len) run += a[(q0 + e) * a_ss];
    local[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? tot[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane < kWarps) tot[lane] = v;
  }
  __syncthreads();
  const float prefix = (incl - run) + (warp > 0 ? tot[warp - 1] : 0.f);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < per && q0 + e < q_len) acs[q0 + e] = prefix + local[e];
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const Params p) {
  constexpr int ROWS = BR / kWarps;     // rows of a tile per warp
  constexpr int CJ = BC / 32;           // key columns per lane
  constexpr int PJ = (P + 31) / 32;     // head-dim columns per lane (y)
  constexpr int PW = P / kWarps;        // head-dim columns per warp (state update)
  constexpr int NJ = kMaxState / 32;    // state rows per lane (state update)
  constexpr int HS = P + 1;             // row stride of h^T
  static_assert(P % kWarps == 0 && BR % kWarps == 0 && BC % 32 == 0, "tile shape");

  const int N = p.n, Q = p.chunk;
  const Layout lay(P, N, Q);
  extern __shared__ __align__(16) float smem[];
  float* Ht = smem + lay.ht;
  float* Cs = smem + lay.cs;
  float* Bt = smem + lay.bt;
  float* Xs = smem + lay.xs;
  float* Ps = smem + lay.ps;
  float* acs = smem + lay.acs;
  float* dec = smem + lay.dec;
  float* tot = smem + lay.tot;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads, g = h / p.rep;
  const T* xb = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* ab = p.dt_a + b * p.a_sb + h * p.a_sh;
  const T* bb = static_cast<const T*>(p.b) + b * p.b_sb + g * p.b_sg;
  const T* cb = static_cast<const T*>(p.c) + b * p.c_sb + g * p.c_sg;
  T* yb = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;

  // The entering state, transposed into h^T.
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int pp = idx / N, n = idx % N;
    Ht[n * HS + pp] = p.init ? p.init[b * p.i_sb + h * p.i_sh + pp * p.i_sp + n] : 0.f;
  }

  const int n_chunks = p.seqlen / Q;
  const int n_tiles = (Q + BR - 1) / BR;
  const int row0 = warp * ROWS;

  for (int ck = 0; ck < n_chunks; ++ck) {
    const long long s0 = static_cast<long long>(ck) * Q;
    __syncthreads();  // the previous chunk is done with acs, dec and h^T; h^T is written
    chunk_cumsum(ab + s0 * p.a_ss, p.a_ss, Q, acs, tot);
    __syncthreads();
    const float a_last = acs[Q - 1];
    for (int q = tid; q < Q; q += kThreads) dec[q] = expf(a_last - acs[q]);

    float dh[NJ][PW];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int u = 0; u < PW; ++u) dh[j][u] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int r0 = it * BR;
      __syncthreads();  // Cs is free; dec is written
      for (int r = warp; r < BR; r += kWarps) {
        const int row = r0 + r;
        for (int n = lane; n < N; n += 32)
          Cs[r * N + n] = row < Q ? to_float(cb[(s0 + row) * p.c_ss + n]) : 0.f;
      }
      __syncthreads();

      // y_i = exp(acs_i) (C_i h^T): the entering state's contribution.
      float acc[ROWS][PJ];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int k = 0; k < PJ; ++k) acc[i][k] = 0.f;
#pragma unroll 2
      for (int n0 = 0; n0 < N; n0 += 4) {
        float hv[4][PJ];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < PJ; ++k) {
            const int pp = lane + 32 * k;
            hv[u][k] = pp < P ? Ht[(n0 + u) * HS + pp] : 0.f;
          }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float4 c4 = *reinterpret_cast<const float4*>(&Cs[(row0 + i) * N + n0]);
#pragma unroll
          for (int k = 0; k < PJ; ++k) {
            float a = acc[i][k];
            a = fmaf(c4.x, hv[0][k], a);
            a = fmaf(c4.y, hv[1][k], a);
            a = fmaf(c4.z, hv[2][k], a);
            a = fmaf(c4.w, hv[3][k], a);
            acc[i][k] = a;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = r0 + row0 + i;
        const float e = row < Q ? expf(acs[row]) : 0.f;
#pragma unroll
        for (int k = 0; k < PJ; ++k) acc[i][k] *= e;
      }

      const bool last = it == n_tiles - 1;
      for (int jt = 0; jt <= it; ++jt) {
        const int c0 = jt * BC;
        __syncthreads();  // every warp is done with the previous Bt, Xs and Ps
        for (int r = warp; r < BC; r += kWarps) {
          const int col = c0 + r;
          for (int n = lane; n < N; n += 32)
            Bt[n * (BC + 1) + r] = col < Q ? to_float(bb[(s0 + col) * p.b_ss + n]) : 0.f;
          for (int pp = lane; pp < P; pp += 32)
            Xs[r * P + pp] = col < Q ? to_float(xb[(s0 + col) * p.x_ss + pp]) : 0.f;
        }
        __syncthreads();

        // Scores C_i B_j^T for this warp's rows and this lane's columns.
        float s[ROWS][CJ];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int jc = 0; jc < CJ; ++jc) s[i][jc] = 0.f;
#pragma unroll 2
        for (int n0 = 0; n0 < N; n0 += 4) {
          float bv[4][CJ];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int jc = 0; jc < CJ; ++jc) bv[u][jc] = Bt[(n0 + u) * (BC + 1) + lane + 32 * jc];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float4 c4 = *reinterpret_cast<const float4*>(&Cs[(row0 + i) * N + n0]);
#pragma unroll
            for (int jc = 0; jc < CJ; ++jc) {
              float a = s[i][jc];
              a = fmaf(c4.x, bv[0][jc], a);
              a = fmaf(c4.y, bv[1][jc], a);
              a = fmaf(c4.z, bv[2][jc], a);
              a = fmaf(c4.w, bv[3][jc], a);
              s[i][jc] = a;
            }
          }
        }
        // Decay and the causal mask, by select.
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int row = r0 + row0 + i;
#pragma unroll
          for (int jc = 0; jc < CJ; ++jc) {
            const int col = c0 + lane + 32 * jc;
            const bool visible = row < Q && col <= row;
            Ps[(row0 + i) * BC + lane + 32 * jc] =
                visible ? s[i][jc] * expf(acs[row] - acs[col]) : 0.f;
          }
        }
        __syncwarp();  // each warp reads back only its own rows of Ps

        // y_i += S_ij X_j for this warp's rows and this lane's head-dim columns.
#pragma unroll 2
        for (int c = 0; c < BC; c += 4) {
          float xv[4][PJ];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int k = 0; k < PJ; ++k) {
              const int pp = lane + 32 * k;
              xv[u][k] = pp < P ? Xs[(c + u) * P + pp] : 0.f;
            }
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float4 p4 = *reinterpret_cast<const float4*>(&Ps[(row0 + i) * BC + c]);
#pragma unroll
            for (int k = 0; k < PJ; ++k) {
              float a = acc[i][k];
              a = fmaf(p4.x, xv[0][k], a);
              a = fmaf(p4.y, xv[1][k], a);
              a = fmaf(p4.z, xv[2][k], a);
              a = fmaf(p4.w, xv[3][k], a);
              acc[i][k] = a;
            }
          }
        }

        // The last row tile sees every key tile: accumulate the state update
        // sum_j X_j^T (B_j exp(acs_last - acs_j)) there.
        if (last) {
          const int cols = min(BC, Q - c0);
          for (int c = 0; c < cols; ++c) {
            const float w = dec[c0 + c];
            float bw[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int n = lane + 32 * j;
              bw[j] = n < N ? Bt[n * (BC + 1) + c] * w : 0.f;
            }
#pragma unroll
            for (int u = 0; u < PW; ++u) {
              const float xc = Xs[c * P + warp * PW + u];
#pragma unroll
              for (int j = 0; j < NJ; ++j) dh[j][u] = fmaf(bw[j], xc, dh[j][u]);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = r0 + row0 + i;
        if (row >= Q) continue;
#pragma unroll
        for (int k = 0; k < PJ; ++k) {
          const int pp = lane + 32 * k;
          if (pp < P) yb[(s0 + row) * p.y_ss + pp] = from_float<T>(acc[i][k]);
        }
      }
    }

    __syncthreads();  // every row tile has read the entering state
    const float chunk_decay = expf(a_last);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = lane + 32 * j;
      if (n >= N) continue;
#pragma unroll
      for (int u = 0; u < PW; ++u) {
        float* hp = &Ht[n * HS + warp * PW + u];
        *hp = fmaf(*hp, chunk_decay, dh[j][u]);
      }
    }
  }

  __syncthreads();
  float* fin = p.final_state + (static_cast<long long>(b) * p.heads + h) * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int pp = idx / N, n = idx % N;
    fin[idx] = Ht[n * HS + pp];
  }
}

template <typename T, int P>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = Layout(P, p.n, p.chunk).total * int(sizeof(float));
  // Above 48 KB a block needs the opt-in; set it on every call, it is cheap.
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  ssd_scan_kernel<T, P><<<batch * p.heads, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const Params& p, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return kUnsupported;
  }
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. dt_a, the initial state
// (null for zeros) and the final state are float32. strides: 18 element
// strides, (batch, sequence, head) for x and dt_a, (batch, sequence, group)
// for B and C, (batch, head, head dim) for the initial state, (batch,
// sequence, head) for y; every last dim has stride 1. The final state is a
// contiguous (batch, heads, P, N) tensor. seqlen must be a multiple of
// chunk. Returns 0 on a successful launch, a cudaError_t code, or -1 for
// sizes or a dtype that are not compiled.
int ssd_scan_fwd(const void* x, const void* dt_a, const void* b, const void* c,
                 const void* init, void* y, void* final_state, int dtype,
                 int batch, int seqlen, int heads, int groups, int head_dim, int state,
                 int chunk, const long long* strides, void* stream) {
  if (batch < 1 || heads < 1 || groups < 1 || heads % groups || chunk < 1 ||
      chunk > kMaxChunk || seqlen % chunk || state < 4 || state > kMaxState || state % 4)
    return kUnsupported;
  Params p;
  p.x = x;
  p.dt_a = static_cast<const float*>(dt_a);
  p.b = b;
  p.c = c;
  p.init = static_cast<const float*>(init);
  p.y = y;
  p.final_state = static_cast<float*>(final_state);
  p.x_sb = strides[0]; p.x_ss = strides[1]; p.x_sh = strides[2];
  p.a_sb = strides[3]; p.a_ss = strides[4]; p.a_sh = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7]; p.b_sg = strides[8];
  p.c_sb = strides[9]; p.c_ss = strides[10]; p.c_sg = strides[11];
  p.i_sb = strides[12]; p.i_sh = strides[13]; p.i_sp = strides[14];
  p.y_sb = strides[15]; p.y_ss = strides[16]; p.y_sh = strides[17];
  p.heads = heads;
  p.rep = heads / groups;
  p.seqlen = seqlen;
  p.n = state;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float>(p, batch, head_dim, st);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(p, batch, head_dim, st);
  return kUnsupported;
}

const char* ssd_scan_error_string(int code) {
  if (code == kUnsupported) return "sizes or dtype not compiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
