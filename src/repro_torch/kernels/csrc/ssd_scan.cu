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
// B and C of head h are those of group h / (H / G). y is written in x's
// dtype and the final state in fp32. The initial state is optional (zeros
// when absent).
//
// What bounds it on this card. At the serving shape (B 8, S 512, H 64,
// P 64, N 128, G 1, Q 256, bf16) the bytes that must move are x and y
// (67 MB), the entering and final states (34 MB) and dt_a, B and C (3 MB):
// about 0.031 ms at 3.35 TB/s. The visible work, 2 (N + P) per (i >= j)
// pair plus 4 N P per position, is 21.5 GFLOP: 0.022 ms on the bf16 tensor
// cores. So the function is memory-bound.
//
// The TPU kernel's grid is (B, H, chunks) with the chunk axis run in order
// and h carried in VMEM scratch; it holds a whole Q = 256 chunk at once.
// CUDA blocks run in no order and shared memory is far smaller than VMEM, so
// both kernels here give one CTA of 8 warps to one (b, h), loop over its
// chunks in order, and walk each chunk in row tiles against 64-row key tiles
// j <= i, with the score (C_i B_j^T) exp(acs_i - acs_j) and no softmax. The
// triangular mask is a select, never a product with 0: above the diagonal
// exp(acs_i - acs_j) grows with the chunk and inf * 0 is NaN. acs is a
// block-wide scan of dt_a. Rows past Q are zeros and masked, so any chunk up
// to 1024 runs; S must be a multiple of Q (the caller pads). Every input is
// addressed through element strides with a unit stride on its last dim.
//
// * bf16 (the serving path): `ssd_scan_bf16_kernel`, all four products on
//   the tensor cores (mma.sync m16n8k16, bf16 operands, fp32 sums).
//     - Row tiles of 128 rows: warp w owns rows 16w..16w+15. C_i is staged
//       once per row tile; B_j and X_j key tiles sit in a 2-stage cp.async
//       ring, the next tile (of this row tile, the next, or the next chunk)
//       in flight while this one is computed. Rows are padded by 16 bytes
//       (conflict-free ldmatrix); N is zero-padded to a multiple of 16.
//     - y_i starts as exp(acs_i) (C_i h^T) from a bf16 copy of the entering
//       state in shared memory ([P][N], the B operand as it lies).
//     - Per key tile, in halves of 32 columns: S = C_i B_j^T (B_j as it
//       lies, N contiguous); the decay and mask applied in fp32 on the
//       accumulator; S rounded to bf16 and repacked in registers as the A
//       operand of y_i += S X_j, X_j through ldmatrix.trans.
//     - The fp32 state lives in registers for the whole scan, as the
//       accumulator of the state update: warp w owns 16 state rows and
//       P / 16 pairs of 8-column blocks. Each chunk scales it by
//       exp(acs_last); the last row tile, which visits every key tile, adds
//       X_j^T (B_j exp(acs_last - acs_j)), both operands through
//       ldmatrix.trans, the rows of B scaled in fp32 in registers and
//       rounded to bf16. After each chunk the bf16 copy is rewritten.
//     - Shared memory at P 64, N 128, Q 256: 107,552 bytes, so with at most
//       128 registers a thread (P <= 64) two CTAs run on each SM. Fitting
//       the state, y and a score slice in 128 registers without spills takes
//       care: every shared array sits at a compile-time offset (B and C rows
//       always 128 + 8 wide, zeros past N), the CTA's global bases live in
//       shared memory, and lane addresses used once per row tile are
//       recomputed where they are used.
//   Against the Pallas kernel, which upcasts to fp32 before each product,
//   the added roundings are the masked, decayed scores, the bf16 copy of
//   h, and B exp(acs_last - acs). Sources that are not 16-byte aligned (a
//   pointer, or a stride that is not a multiple of 8 elements, as B/C with
//   N = 20) are staged with ordinary loads: a template flag set by the C
//   entry.
// * fp32: `ssd_scan_f32_kernel`, scalar fp32 FMAs on the CUDA cores, exact
//   fp32 like the Pallas kernel's fp32 dots. 64-row tiles; h^T in shared
//   memory (odd row stride); lanes own key and head-dim columns; scores
//   through shared memory; the last row tile accumulates the update in
//   registers and h^T is overwritten after a barrier that follows every
//   row tile's read of the entering state. 134,176 bytes of shared memory
//   at P 64, N 128, Q 256: one CTA per SM.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; bound through ctypes (a plain C interface).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int BR = 64;          // chunk rows per row tile (fp32)
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

// --------------------------------------------------------------------------
// fp32: scalar FMAs
// --------------------------------------------------------------------------

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Shared-memory layout, in floats; every array starts on a 16-byte boundary.
struct F32Layout {
  int ht, cs, bt, xs, ps, acs, dec, tot, total;
  __host__ __device__ F32Layout(int p, int n, int q) {
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

// acs[q * stride] = dt_a[0] + ... + dt_a[q] for q < Q (Q <= 4 * kThreads): each thread
// sums up to four consecutive entries, then a warp scan and a scan of the
// warp totals give every thread its prefix.
__device__ void chunk_cumsum(const float* a, long long a_ss, int q_len, float* acs, int stride,
                             float* tot) {
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
    if (e < per && q0 + e < q_len) acs[(q0 + e) * stride] = prefix + local[e];
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_f32_kernel(const Params p) {
  constexpr int ROWS = BR / kWarps;     // rows of a tile per warp
  constexpr int CJ = BC / 32;           // key columns per lane
  constexpr int PJ = (P + 31) / 32;     // head-dim columns per lane (y)
  constexpr int PW = P / kWarps;        // head-dim columns per warp (state update)
  constexpr int NJ = kMaxState / 32;    // state rows per lane (state update)
  constexpr int HS = P + 1;             // row stride of h^T
  static_assert(P % kWarps == 0 && BR % kWarps == 0 && BC % 32 == 0, "tile shape");

  const int N = p.n, Q = p.chunk;
  const F32Layout lay(P, N, Q);
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
  const float* xb = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* ab = p.dt_a + b * p.a_sb + h * p.a_sh;
  const float* bb = static_cast<const float*>(p.b) + b * p.b_sb + g * p.b_sg;
  const float* cb = static_cast<const float*>(p.c) + b * p.c_sb + g * p.c_sg;
  float* yb = static_cast<float*>(p.y) + b * p.y_sb + h * p.y_sh;

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
    chunk_cumsum(ab + s0 * p.a_ss, p.a_ss, Q, acs, 1, tot);
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
          Cs[r * N + n] = row < Q ? cb[(s0 + row) * p.c_ss + n] : 0.f;
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
            Bt[n * (BC + 1) + r] = col < Q ? bb[(s0 + col) * p.b_ss + n] : 0.f;
          for (int pp = lane; pp < P; pp += 32)
            Xs[r * P + pp] = col < Q ? xb[(s0 + col) * p.x_ss + pp] : 0.f;
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
          if (pp < P) yb[(s0 + row) * p.y_ss + pp] = acc[i][k];
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
  float* fin = p.final_state + static_cast<long long>(blockIdx.x) * P * N;  // (b, h) = blockIdx.x
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int pp = idx / N, n = idx % N;
    fin[idx] = Ht[n * HS + pp];
  }
}


// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int BRT = kWarps * 16;  // chunk rows per row tile (bf16)
constexpr int KC = 32;            // key columns per score slice (bf16)
constexpr int kKkUnroll = 2;      // unroll of the score product's loop over N
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of the bf16 kernel, in bytes; every array starts on a
// 16-byte boundary. Rows of B, C and h hold LDN = 128 + 8 elements whatever
// N is (N is zero-padded to a multiple of 16, at most 128), so that every
// ldmatrix offset is a compile-time constant; rows of X hold P + 8.
constexpr int LDN = kMaxState + 8;

template <int P>
struct Bf16Layout {
  static constexpr int cs = 0;                        // C tile: [BRT][LDN]
  static constexpr int bs = cs + BRT * LDN * 2;       // B key tiles: [2][BC][LDN]
  static constexpr int xs = bs + 2 * BC * LDN * 2;    // X key tiles: [2][BC][P + 8]
  static constexpr int hs = xs + 2 * BC * (P + 8) * 2;  // bf16 state: [P][LDN]
  static constexpr int ad = hs + P * LDN * 2;         // (acs, exp(acs_last - acs)): [qp]
  // acs and dec cover every row tile; the per-warp scan totals follow them.
  __host__ __device__ static int qp(int q) { return (q + BRT - 1) / BRT * BRT; }
  __host__ __device__ static int tot(int q) { return ad + qp(q) * 8; }
  __host__ __device__ static int total(int q) { return tot(q) + kWarps * 4; }
};

template <int P, bool kAsync>
__global__ void __launch_bounds__(kThreads, P <= 64 ? 2 : 1) ssd_scan_bf16_kernel(const Params p) {
  constexpr int LDP = P + 8;
  constexpr int PB = P / 8;        // n-blocks of y
  constexpr int WN = 128 / P;      // warps that share one 16-row strip of the state
  constexpr int NPAIR = P / 16;    // 16-column blocks of the state per warp
  constexpr int CHP = P / 8;       // 16-byte chunks per X row
  static_assert(P % 16 == 0 && P <= 128 && BC == 64, "tile shape");

  using Lay = Bf16Layout<P>;
  const int N = p.n, Q = p.chunk;
  const int NK = (N + 15) / 16;            // k-blocks of N padded to a multiple of 16
  constexpr int CHN = kMaxState / 8;       // 16-byte chunks per B/C row: all staged, zeros past N
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* Cs = reinterpret_cast<bf16*>(sm + Lay::cs);
  bf16* Bs = reinterpret_cast<bf16*>(sm + Lay::bs);
  bf16* Xs = reinterpret_cast<bf16*>(sm + Lay::xs);
  bf16* Hs = reinterpret_cast<bf16*>(sm + Lay::hs);
  float2* ad = reinterpret_cast<float2*>(sm + Lay::ad);  // .x acs, .y dec

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  // This CTA's x, B, C and y bases, kept in shared memory rather than in
  // 64-bit registers for the whole scan (read back where used).
  __shared__ const bf16* bases[4];
  if (tid == 0) {
    const int grp = h / p.rep;
    bases[0] = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh;
    bases[1] = static_cast<const bf16*>(p.b) + b * p.b_sb + grp * p.b_sg;
    bases[2] = static_cast<const bf16*>(p.c) + b * p.c_sb + grp * p.c_sg;
    bases[3] = static_cast<const bf16*>(p.y) + b * p.y_sb + h * p.y_sh;
  }
  const uint32_t cs_s = tc::smem_addr(Cs), bs_s = tc::smem_addr(Bs), xs_s = tc::smem_addr(Xs);

  // Rows [row0, row0 + rows) of a (seq, width) tensor from sequence position
  // s0 into shared memory (32-bit address `dst`) at row stride `ld`; rows at
  // or past Q, and columns at or past `width`, are zeros.
  auto stage = [&](uint32_t dst, int ld, const bf16* src, long long ss, long long s0, int row0,
                   int rows, int chunks, int width) {
#pragma unroll 1
    for (int idx = tid; idx < rows * chunks; idx += kThreads) {
      const int r = idx / chunks, c = (idx % chunks) * 8;
      const int valid = row0 + r < Q ? min(width - c, 8) : 0;
      tc::stage8<kAsync>(dst + (r * ld + c) * 2,
                         valid > 0 ? src + (s0 + row0 + r) * ss + c : src, valid);
    }
  };
  auto stage_key = [&](int ck, int jt, int st) {
    const long long s0 = static_cast<long long>(ck) * Q;
    stage(bs_s + st * BC * LDN * 2, LDN, bases[1], p.b_ss, s0, jt * BC, BC, CHN, N);
    stage(xs_s + st * BC * LDP * 2, LDP, bases[0], p.x_ss, s0, jt * BC, BC, CHP, P);
  };

  // The state: rows mt*16 + g (+8), columns pb*16 + j*8 + 2*t4 (+1) for the
  // warp's blocks pb = wn + WN * i.
  const int mt = warp / WN, wn = warp % WN;
  float st_acc[NPAIR][2][4];
#pragma unroll
  for (int i = 0; i < NPAIR; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = mt * 16 + g + (e >> 1) * 8;
        const int n = (wn + WN * i) * 16 + j * 8 + 2 * t4 + (e & 1);
        st_acc[i][j][e] = p.init && n < N
                              ? p.init[b * p.i_sb + h * p.i_sh + pp * p.i_sp + n] : 0.f;
      }
  // The bf16 copy of the state that C h^T reads (columns past N stay 0).
  auto write_h = [&]() {
#pragma unroll
    for (int i = 0; i < NPAIR; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int tx = tc::tid_x(), w = tx >> 5;
        const int n = (w % WN + WN * i) * 16 + j * 8 + 2 * (tx & 3);
        const int pp = (w / WN) * 16 + ((tx & 31) >> 2);
        *reinterpret_cast<uint32_t*>(Hs + pp * LDN + n) =
            tc::pack_bf16(st_acc[i][j][0], st_acc[i][j][1]);
        *reinterpret_cast<uint32_t*>(Hs + (pp + 8) * LDN + n) =
            tc::pack_bf16(st_acc[i][j][2], st_acc[i][j][3]);
      }
  };
  write_h();
  __syncthreads();  // bases are written

  // Each lane's ldmatrix addresses (bytes, shared space) at tile offset 0,
  // for the products of every key tile; those used once per row tile (C h^T)
  // or only in the last row tile (the state update) are recomputed there.
  const uint32_t c_frag = tc::smem_addr(Cs + (warp * 16 + tc::a_row(lane)) * LDN + tc::a_col(lane));
  const uint32_t b_frag = tc::smem_addr(Bs + tc::bt_row(lane) * LDN + tc::bt_col(lane));
  const uint32_t x_frag = tc::smem_addr(Xs + tc::bk_row(lane) * LDP + tc::bk_col(lane));

  const int n_chunks = p.seqlen / Q;
  const int n_rt = (Q + BRT - 1) / BRT;
  stage_key(0, 0, 0);
  tc::cp_async_commit();
  int st = 0;

  for (int ck = 0; ck < n_chunks; ++ck) {
    __syncthreads();  // the previous chunk is done with acs and dec; Hs is written
    chunk_cumsum(p.dt_a + b * p.a_sb + h * p.a_sh + static_cast<long long>(ck) * Q * p.a_ss,
                 p.a_ss, Q, &ad[0].x, 2, reinterpret_cast<float*>(sm + Lay::tot(Q)));
    __syncthreads();
    const float a_last = ad[Q - 1].x;
    for (int q = tid; q < Lay::qp(Q); q += kThreads)
      ad[q] = q < Q ? make_float2(ad[q].x, exp2f(kLog2e * (a_last - ad[q].x)))
                    : make_float2(0.f, 0.f);
    const float chunk_decay = expf(a_last);
#pragma unroll
    for (int i = 0; i < NPAIR; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st_acc[i][j][e] *= chunk_decay;

    for (int it = 0; it < n_rt; ++it) {
      // Cs is free: the previous step ended with a barrier.
      stage(cs_s, LDN, bases[2], p.c_ss, static_cast<long long>(ck) * Q, it * BRT, BRT, CHN, N);
      tc::cp_async_commit();
      const int r_lo = it * BRT + warp * 16;  // this warp's first row in the chunk
      const bool live = r_lo < Q;
      const bool last = it == n_rt - 1;
      const int n_kt = (min(Q, (it + 1) * BRT) + BC - 1) / BC;
      float y[PB][4];
#pragma unroll
      for (int j = 0; j < PB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[j][e] = 0.f;

      for (int jt = 0; jt < n_kt; ++jt) {
        // Prefetch the next key tile: of this row tile, the next, or the
        // next chunk.
        if (jt + 1 < n_kt) stage_key(ck, jt + 1, st ^ 1);
        else if (!last) stage_key(ck, 0, st ^ 1);
        else if (ck + 1 < n_chunks) stage_key(ck + 1, 0, st ^ 1);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // the C tile and this key tile have landed
        __syncthreads();
        const uint32_t b_st = st * BC * LDN * 2, x_st = st * BC * LDP * 2;  // stage offsets

        if (jt == 0 && live) {
          // y_i = exp(acs_i) (C_i h^T) from the entering state.
          const int lx = tc::tid_x() & 31;
          const uint32_t h_frag = tc::smem_addr(Hs + tc::bt_row(lx) * LDN + tc::bt_col(lx));
#pragma unroll
          for (int kk = 0; kk < kMaxState / 16; ++kk) {
            if (kk >= NK) break;
            uint32_t ca[4];
            tc::ldmatrix_x4(ca, c_frag + kk * 32);
#pragma unroll
            for (int dp = 0; dp < P / 16; ++dp) {
              uint32_t hb[4];
              tc::ldmatrix_x4(hb, h_frag + (dp * 16 * LDN + kk * 16) * 2);
              tc::mma_bf16(y[2 * dp], ca, hb[0], hb[1]);
              tc::mma_bf16(y[2 * dp + 1], ca, hb[2], hb[3]);
            }
          }
          const int r0 = r_lo + g, r1 = r0 + 8;
          const float e0 = r0 < Q ? exp2f(kLog2e * ad[r0].x) : 0.f;
          const float e1 = r1 < Q ? exp2f(kLog2e * ad[r1].x) : 0.f;
#pragma unroll
          for (int j = 0; j < PB; ++j) {
            y[j][0] *= e0;
            y[j][1] *= e0;
            y[j][2] *= e1;
            y[j][3] *= e1;
          }
        }

        // y_i += (C_i B_j^T o exp(acs_i - acs_j), masked) X_j, in slices of
        // KC key columns, skipping those wholly above this warp's rows.
        const int c0 = jt * BC;
#pragma unroll 1
        for (int hh = 0; hh < BC / KC; ++hh) {
          const int cc = c0 + hh * KC;
          if (!live || cc > r_lo + 15) continue;
          float s[KC / 8][4];
#pragma unroll
          for (int j = 0; j < KC / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll (kKkUnroll)
          for (int kk = 0; kk < NK; ++kk) {
            uint32_t ca[4];
            tc::ldmatrix_x4(ca, c_frag + kk * 32);
#pragma unroll
            for (int np = 0; np < KC / 16; ++np) {
              uint32_t bf[4];
              tc::ldmatrix_x4(bf, b_frag + b_st + ((hh * KC + np * 16) * LDN + kk * 16) * 2);
              tc::mma_bf16(s[2 * np], ca, bf[0], bf[1]);
              tc::mma_bf16(s[2 * np + 1], ca, bf[2], bf[3]);
            }
          }
#pragma unroll
          for (int j = 0; j < KC / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r_lo + g + (e >> 1) * 8;
              const int col = cc + j * 8 + 2 * t4 + (e & 1);
              const bool visible = col <= row && row < Q;
              s[j][e] = visible ? s[j][e] * exp2f(kLog2e * (ad[row].x - ad[col].x)) : 0.f;
            }
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk) {
            uint32_t sa[4];
            tc::acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int dp = 0; dp < P / 16; ++dp) {
              uint32_t xf[4];
              tc::ldmatrix_x4_trans(xf, x_frag + x_st + ((hh * KC + kk * 16) * LDP + dp * 16) * 2);
              tc::mma_bf16(y[2 * dp], sa, xf[0], xf[1]);
              tc::mma_bf16(y[2 * dp + 1], sa, xf[2], xf[3]);
            }
          }
        }

        // The last row tile sees every key tile: the state update
        // h += X_j^T (B_j exp(acs_last - acs_j)).
        if (last) {
          const int tx = tc::tid_x(), lx = tx & 31, w = tx >> 5;
          const uint32_t bk_frag = tc::smem_addr(Bs + tc::bk_row(lx) * LDN + tc::bk_col(lx));
          const uint32_t xa_frag =
              tc::smem_addr(Xs + tc::at_row(lx) * LDP + (w / WN) * 16 + tc::at_col(lx));
#pragma unroll 1
          for (int kk = 0; kk < BC / 16; ++kk) {
            const int j0 = kk * 16;
            const float2* dj = ad + c0 + j0 + 2 * t4;
            const float d0 = dj[0].y, d1 = dj[1].y, d8 = dj[8].y, d9 = dj[9].y;
            uint32_t xa[4];
            tc::ldmatrix_x4_trans(xa, xa_frag + x_st + j0 * LDP * 2);
#pragma unroll
            for (int i = 0; i < NPAIR; ++i) {
              const int n0 = (w % WN + WN * i) * 16;
              uint32_t bf[4];
              tc::ldmatrix_x4_trans(bf, bk_frag + b_st + (j0 * LDN + n0) * 2);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float2 v = tc::unpack_bf16(bf[r]);
                bf[r] = r & 1 ? tc::pack_bf16(v.x * d8, v.y * d9)
                              : tc::pack_bf16(v.x * d0, v.y * d1);
              }
              tc::mma_bf16(st_acc[i][0], xa, bf[0], bf[1]);
              tc::mma_bf16(st_acc[i][1], xa, bf[2], bf[3]);
            }
          }
        }
        __syncthreads();  // every warp is done with this stage (and Cs) before reuse
        st ^= 1;
      }

      if (live) {
        bf16* yb = const_cast<bf16*>(bases[3]) + static_cast<long long>(ck) * Q * p.y_ss;
        const int r0 = r_lo + g, r1 = r0 + 8;
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          const int col = j * 8 + 2 * t4;
          if (r0 < Q)
            *reinterpret_cast<uint32_t*>(yb + r0 * p.y_ss + col) = tc::pack_bf16(y[j][0], y[j][1]);
          if (r1 < Q)
            *reinterpret_cast<uint32_t*>(yb + r1 * p.y_ss + col) = tc::pack_bf16(y[j][2], y[j][3]);
        }
      }
    }
    write_h();  // every warp is past the chunk's last barrier: no one reads Hs
  }

  float* fin = p.final_state + static_cast<long long>(blockIdx.x) * P * N;  // (b, h) = blockIdx.x
#pragma unroll
  for (int i = 0; i < NPAIR; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tx = tc::tid_x(), w = tx >> 5;
      const int n = (w % WN + WN * i) * 16 + j * 8 + 2 * (tx & 3);
      const int pp = (w / WN) * 16 + ((tx & 31) >> 2);
      if (n < N) {
        *reinterpret_cast<float2*>(fin + pp * N + n) =
            make_float2(st_acc[i][j][0], st_acc[i][j][1]);
        *reinterpret_cast<float2*>(fin + (pp + 8) * N + n) =
            make_float2(st_acc[i][j][2], st_acc[i][j][3]);
      }
    }
}

// --------------------------------------------------------------------------
// Launch
// --------------------------------------------------------------------------

// With `query` set, report the kernel's dynamic shared memory and how many
// of its CTAs fit on one SM instead of launching it.
struct Query {
  int* blocks_per_sm;
  int* smem_bytes;
};

template <typename Kernel>
int run(Kernel kernel, const Params& p, int batch, int smem, cudaStream_t stream,
        const Query* query) {
  // Above 48 KB a block needs the opt-in; set it on every call, it is cheap.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  if (query) {
    *query->smem_bytes = smem;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(query->blocks_per_sm, kernel,
                                                             kThreads, smem));
  }
  kernel<<<batch * p.heads, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <int P>
int launch(const Params& p, int batch, int dtype, bool aligned, cudaStream_t stream,
           const Query* query) {
  if (dtype == 0)
    return run(ssd_scan_f32_kernel<P>, p, batch,
               F32Layout(P, p.n, p.chunk).total * int(sizeof(float)), stream, query);
  if (dtype != 1) return kUnsupported;
  const int smem = Bf16Layout<P>::total(p.chunk);
  return aligned ? run(ssd_scan_bf16_kernel<P, true>, p, batch, smem, stream, query)
                 : run(ssd_scan_bf16_kernel<P, false>, p, batch, smem, stream, query);
}

int dispatch_dim(const Params& p, int batch, int dtype, int d, bool aligned, cudaStream_t stream,
                 const Query* query = nullptr) {
  switch (d) {
    case 16: return launch<16>(p, batch, dtype, aligned, stream, query);
    case 32: return launch<32>(p, batch, dtype, aligned, stream, query);
    case 64: return launch<64>(p, batch, dtype, aligned, stream, query);
    case 128: return launch<128>(p, batch, dtype, aligned, stream, query);
    default: return kUnsupported;
  }
}

bool aligned16(const void* ptr, const long long* strides, int n) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] % 8) return false;
  return true;
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. dt_a, the initial state
// (null for zeros) and the final state are float32. strides: 18 element
// strides, (batch, sequence, head) for x and dt_a, (batch, sequence, group)
// for B and C, (batch, head, head dim) for the initial state, (batch,
// sequence, head) for y; every last dim has stride 1. y is a contiguous
// (batch, seqlen, heads, P) tensor and the final state a contiguous (batch,
// heads, P, N) one. seqlen must be a multiple of chunk. Returns 0 on a
// successful launch, a cudaError_t code, or -1 for sizes or a dtype that
// are not compiled.
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
  // cp.async needs 16-byte-aligned sources: every x, B and C row start.
  const bool aligned = aligned16(x, strides, 3) && aligned16(b, strides + 6, 3) &&
                       aligned16(c, strides + 9, 3);
  return dispatch_dim(p, batch, dtype, head_dim, aligned, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of the kernel that (dtype, head_dim, state,
// chunk, aligned) selects and how many of its CTAs fit on one SM. Returns 0
// or an error code as ssd_scan_fwd does.
int ssd_scan_occupancy(int dtype, int head_dim, int state, int chunk, int aligned,
                       int* blocks_per_sm, int* smem_bytes) {
  if (chunk < 1 || chunk > kMaxChunk || state < 4 || state > kMaxState || state % 4)
    return kUnsupported;
  Params p{};
  p.n = state;
  p.chunk = chunk;
  const Query query{blocks_per_sm, smem_bytes};
  return dispatch_dim(p, 1, dtype, head_dim, aligned != 0, nullptr, &query);
}

const char* ssd_scan_error_string(int code) {
  if (code == kUnsupported) return "sizes or dtype not compiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
