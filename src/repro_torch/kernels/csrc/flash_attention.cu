// Flash attention for NVIDIA Hopper (sm_90a): the forward of the serving
// path, and the forward and backward of the training path.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, called through
// `flash_attention` in src/repro/kernels/flash_attention.py, and computes the
// same function: softmax(scale * Q K^T + top-left causal mask) V with GQA
// (query head h reads kv head h / (Hq / Hkv)), kv tiles wholly above the
// diagonal skipped, fp32 running max, normaliser and accumulator, 0 for rows
// whose normaliser is 0, and the output in q's dtype.
//
// What bounds it on this card. At the prefill shapes of the serving path
// (q 9 heads, k/v 3 heads, head dim 64, a few hundred tokens) the bytes that
// must move are q, k, v and o once each, a few MB, and the causal work is
// about 4 * D operations per visible (row, column) pair: on the bf16 tensor
// cores the card could finish either in microseconds, and the bytes take
// longer, so the function is memory-bound; what a kernel can lose is latency
// (staging that does not overlap the products) and products off the tensor
// cores.
//
// Serving's forward: two kernels, chosen by dtype:
//
// * bf16 (the serving path): `flash_fwd_bf16_kernel`, on the tensor cores.
//   One CTA of 4 warps per (b, hq, 64-row q tile), heaviest causal tiles
//   first; warp w owns q rows 16w..16w+15 of the tile.
//     - The q tile goes to bf16 shared memory through cp.async, then into
//       mma A fragments held in registers for the whole kv loop.
//     - K and V tiles of 64 rows sit in a 2-stage cp.async ring of bf16
//       shared memory: tile t + 1 is in flight while t is computed. Rows
//       are padded by 16 bytes, so ldmatrix reads are free of bank
//       conflicts; rows past Sk are zero-filled by the copy itself.
//     - S = Q K^T on mma.sync m16n8k16 (K through ldmatrix), fp32 sums; the
//       causal mask and the ragged Sk edge are a select to -1e30, applied
//       only on tiles that cross them.
//     - The online softmax runs on the accumulator fragment in the base-2
//       domain (scale * log2 e folded in); the row max reduces over the 4
//       lanes of a quad with two shuffles, the row sum once at the end.
//     - P is rounded to bf16 and repacked from the accumulator into A
//       fragments in registers; O += P V with V through ldmatrix.trans.
//     - The output goes back through the q tile's shared memory (each warp
//       its own rows) and out in 16-byte stores.
//   Shared memory: 5 tiles of 64 x (D + 8) bf16, 46,080 bytes at D = 64;
//   with at most 128 registers a thread (the launch bound for D <= 64) four
//   CTAs fit on an SM, which measured faster than three with more
//   registers. Q K^T in bf16 with fp32 sums gives the Pallas kernel's
//   products (it upcasts bf16 before each dot) in another order; the one
//   added rounding is P to bf16.
//   Sources that are not 16-byte aligned (a pointer, or a stride that is not
//   a multiple of 8 elements) are staged with ordinary loads instead of
//   cp.async: a template flag that the C entry sets.
//
// * fp32: `flash_fwd_f32_kernel`, scalar fp32 FMAs on the CUDA cores, exact
//   fp32 like the Pallas kernel's fp32 dots. 4 warps; lane l owns kv columns
//   l, l + 32 and head-dim columns l, l + 32, ...; q and kv tiles staged as
//   fp32 (K transposed, odd stride), P through shared memory.
//
// Both mask the ragged edges of Sq and Sk in the kernel (rows past Sq are
// computed and not stored; columns past Sk score -1e30), and address every
// tensor through element strides with a unit stride on the head dim, so the
// caller passes (B, S, H, D) activations as (B, H, S, D) views without a copy.
//
// Training (bf16, head dims 64 and 128). The JAX package trains through its
// plain attention (`_attn_core` in src/repro/models/layers.py: bf16 q and k
// products with fp32 sums, an fp32 softmax, P rounded to v's dtype before
// P V); no Pallas kernel is replaced. Training's kernels compute that
// function and its gradient without writing a score or a probability to
// device memory.
//
// * The forward is `flash_fwd_bf16_kernel` with kLse on: it also writes each
//   query row's log-sum-exp of its scaled, masked scores (natural log,
//   fp32) to lse[(b * hq + h) * lse_rows + row], for every row of the row's
//   64-row tile: +inf past Sq, so that the backward, which reads whole
//   tiles, finds probabilities of 0 there. Serving's instantiations leave
//   it off (a null `lse`): the epilogue's extra registers would make the
//   D 64 kernel spill, and the output's bits are the same either way.
//
// What bounds the backward on this card. At olmo-1b's training shape (8, 16,
// 2048, 128), causal, its five products of the visible blocks are 344 GFLOP
// (2.5 forward products' worth) against 34 MB of q, k, v, o, dO and their
// gradients: 0.35 ms of tensor-core time against 0.01 ms of bytes. It is
// bound by operations; what a kernel can lose is products off the tensor
// cores, staging that does not overlap them, and registers that force
// spills or leave one CTA an SM.
//
// The backward is two kernels, in this order on one stream; neither uses an
// atomic, so two runs give the same bits:
//
// * `flash_bwd_dq_kernel`: one CTA of 4 warps per (b, q head, 64-row q
//   tile), heaviest causal tiles first; warp w owns q rows 16w..16w+15. It
//   first computes delta = rowsum(dO o O) in fp32 for its rows (written out
//   for the next kernel; 0 past Sq) while its q and dO tiles and the first
//   k and v tiles land in shared memory through cp.async. Then, over the kv
//   tiles up to the causal diagonal (2-stage ring as in the forward):
//   S = Q K^T and dP = dO V^T on mma.sync m16n8k16 with fp32 sums,
//   P = exp2(S * scale * log2 e - lse * log2 e) from the forward's lse,
//   dS = P o (dP - delta), and dQ += dS K with dS rounded to bf16 and
//   repacked in registers as the A operand (K through ldmatrix.trans).
//   dQ = scale * the sum, stored in q's dtype.
// * `flash_bwd_dkdv_kernel`: one CTA of 4 warps per (b, kv head, 64-row kv
//   tile); warp w owns kv rows 16w..16w+15, and the CTA loops over the q
//   tiles from the diagonal on of every q head that reads this kv head
//   (head h reads kv head h / group), so GQA's sum over the group happens
//   in the CTA's fp32 registers. The k and v tiles stay in shared memory;
//   q, dO, lse and delta tiles come through a 2-stage cp.async ring. Per q
//   tile, in passes of NQ columns (32 at head dim 128, which keeps the
//   score fragments' registers beside dK's and dV's 128): S^T = K Q^T,
//   P^T from lse, dV += P^T dO (P rounded to bf16, as the forward rounds
//   it), dP^T = V dO^T, dS^T = P^T o (dP^T - delta), dK += dS^T Q (dS
//   rounded to bf16). dK = scale * the sum.
//
// dS enters the dQ and dK products rounded to bf16, as the JAX package's
// default-precision products round their fp32 operands on its TPU; every
// sum is fp32. Causal tiles wholly above the diagonal are skipped; the tiles
// that cross it, and the ragged edges of Sk, are masked by a select to 0 of
// P; rows past Sq read lse = +inf from the forward, so their P is 0 too.
// Shared memory: 6 tiles of 64 x (D + 8) bf16 (104,448 bytes at D 128,
// with 1 KB of lse and delta in the dK/dV kernel), 2 CTAs an SM. The
// training entries take only tensors whose row starts are 16-byte aligned
// (cp.async; the wrapper copies any other), and lse and delta as (B, Hq,
// Sq rounded up to 64) contiguous fp32.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; bound through ctypes (a plain C interface).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // kv rows per staged tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kUnsupported = -1;
constexpr int kUnaligned = -2;

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
  float* lse;    // training's forward: (B, Hq, lse_rows) fp32, see the top
  int lse_rows;  // Sq rounded up to a multiple of BQ
};

// --------------------------------------------------------------------------
// fp32: scalar FMAs
// --------------------------------------------------------------------------

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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const Params p) {
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
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = q_start + r;
    Qs[idx] = row < p.sq ? qb[row * p.q_ss + c] : 0.f;
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
        kx = kb[kr * p.k_ss + c];
        vx = vb[kr * p.v_ss + c];
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
      if (d < D) ob[row * p.o_ss + d] = acc[i][j] / safe_l;
    }
  }
}

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
constexpr int bf16_smem_bytes() {
  return 5 * BQ * (D + 8) * int(sizeof(bf16));  // Q, then 2 stages of K and V
}

template <int D, bool kAsync, bool kLse = false>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 1) flash_fwd_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;    // shared row stride in elements: 16-byte pad
  constexpr int KD = D / 16;   // k-blocks of the head dim (Q K^T)
  constexpr int ND = D / 8;    // n-blocks of the output (P V)
  constexpr int NS = BK / 8;   // n-blocks of a score tile
  constexpr int CH = D / 8;    // 16-byte chunks per row
  static_assert(BQ == kWarps * 16 && BK % 16 == 0 && D % 16 == 0, "tile shape");

  extern __shared__ __align__(16) bf16 sm[];
  bf16* Qs = sm;                // [BQ][LD]; reused for the output tile
  bf16* Ks = Qs + BQ * LD;      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // 64 rows from `row0` of a (rows, D) tensor into shared memory; rows at or
  // past `rows` are zeros.
  auto stage = [&](bf16* dst, const bf16* src, long long ss, int row0, int rows) {
    const uint32_t base = tc::smem_addr(dst);
#pragma unroll 1
    for (int idx = tid; idx < 64 * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const bool ok = row0 + r < rows;
      tc::stage8<kAsync>(base + (r * LD + c) * 2, ok ? src + (row0 + r) * ss + c : src,
                         ok ? 8 : 0);
    }
  };

  int n_tiles = (p.sk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q_start + BQ - 1) / BK + 1);

  stage(Qs, qb, p.q_ss, q_start, p.sq);
  stage(Ks, kb, p.k_ss, 0, p.sk);
  stage(Vs, vb, p.v_ss, 0, p.sk);
  tc::cp_async_commit();

  const int row_lo = q_start + warp * 16;  // this warp's first q row
  // Each lane's ldmatrix addresses (bytes, shared space) at tile offset 0.
  const uint32_t q_frag = tc::smem_addr(Qs + (warp * 16 + tc::a_row(lane)) * LD + tc::a_col(lane));
  const uint32_t k_frag = tc::smem_addr(Ks + tc::bt_row(lane) * LD + tc::bt_col(lane));
  const uint32_t v_frag = tc::smem_addr(Vs + tc::bk_row(lane) * LD + tc::bk_col(lane));
  constexpr uint32_t kStage = BK * LD * sizeof(bf16);
  const float sl2 = p.scale * kLog2e;
  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      stage(Ks + (st ^ 1) * BK * LD, kb, p.k_ss, (t + 1) * BK, p.sk);
      stage(Vs + (st ^ 1) * BK * LD, vb, p.v_ss, (t + 1) * BK, p.sk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::ldmatrix_x4(qf[kk], q_frag + kk * 32);
    }
    const uint32_t k_tile = k_frag + st * kStage, v_tile = v_frag + st * kStage;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bf[4];
        tc::ldmatrix_x4(bf, k_tile + (np * 16 * LD + kk * 16) * 2);
        tc::mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }

    // Scale into the base-2 domain; mask only where the tile crosses the
    // diagonal or the end of k.
    const int k_start = t * BK;
    const bool edge = k_start + BK > p.sk || (p.causal && k_start + BK - 1 > row_lo);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int row = row_lo + g + (e >> 1) * 8;
          const int col = k_start + j * 8 + 2 * t4 + (e & 1);
          const bool visible = col < p.sk && (!p.causal || col <= row);
          x = visible ? x : kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = pr;
        l[e >> 1] += pr;  // this lane's columns; the quad sums at the end
      }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P rounded to bf16 and repacked in registers.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      tc::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, v_tile + (kk * 16 * LD + dp * 16) * 2);
        tc::mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        tc::mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Epilogue: O / l (0 -> 1), through this warp's own rows of Qs, then out
  // in 16-byte stores. The output's strides are those of q (a dense layout
  // with a unit head-dim stride) or contiguous, so its rows are 16-byte
  // aligned.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  if (kLse && t4 == 0) {
    // m and l are in the base-2 domain of scale * log2(e) * S.
    float* lse = p.lse + (static_cast<long long>(b) * p.hq + h) * p.lse_rows;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + g + 8 * r;
      lse[row] = row < p.sq && l[r] > 0.f ? (m[r] + log2f(l[r])) / kLog2e
                                               : __int_as_float(0x7f800000);  // +inf
    }
  }
  bf16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(Os + g * LD + c) =
        tc::pack_bf16(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * LD + c) =
        tc::pack_bf16(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = (idx % CH) * 8, row = row_lo + r;
    if (row < p.sq)
      *reinterpret_cast<uint4*>(ob + row * p.o_ss + c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c);
  }
}

// --------------------------------------------------------------------------
// bf16 backward: dQ, then dK and dV
// --------------------------------------------------------------------------

// Tensors of the backward, in the order of the strides the C entry takes.
enum Tensor { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (B, Hq, rows), the forward's
  float* delta;      // (B, Hq, rows), written by the dQ kernel
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long sb[kTensors], sh[kTensors], ss[kTensors];  // batch, head, sequence
  int batch, hq, hkv, group, sq, sk, rows, causal;
  float scale;
};

template <int D>
constexpr int bwd_smem_bytes() {
  return 6 * BQ * (D + 8) * int(sizeof(bf16));
}

// 64 rows from `row0` of a (rows, D) bf16 tensor into a [64][D + 8] tile of
// shared memory through cp.async; rows at or past `rows` are zeros.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long ss, int row0,
                                           int rows) {
  constexpr int LD = D + 8, CH = D / 8;
  const uint32_t base = tc::smem_addr(dst);
#pragma unroll
  for (int idx = threadIdx.x; idx < 64 * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = row0 + r < rows;
    tc::cp_async16(base + (r * LD + c) * 2, ok ? src + (row0 + r) * ss + c : src, ok ? 16 : 0);
  }
}

// A warp's 16 x D fp32 accumulator times `mul`, as bf16 into its 16 rows of
// a [.][D + 8] tile of shared memory.
template <int D>
__device__ __forceinline__ void frag_to_smem(bf16* tile, const float (&acc)[D / 8][4], float mul,
                                             int g, int t4) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(tile + g * LD + c) = tc::pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(tile + (g + 8) * LD + c) =
        tc::pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// A warp's 16 rows of a shared tile out to rows row0.. of a tensor, in
// 16-byte stores; rows at or past `rows` are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long ss, const bf16* tile, int row0,
                                           int rows, int lane) {
  constexpr int LD = D + 8, CH = D / 8;
#pragma unroll
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = (idx % CH) * 8;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * ss + c) =
          *reinterpret_cast<const uint4*>(tile + r * LD + c);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8, NS = BK / 8;
  static_assert(BQ == kWarps * 16 && D % 64 == 0, "tile shape");

  extern __shared__ __align__(16) bf16 sm[];
  bf16* Qs = sm;                // [BQ][LD]; the dQ tile at the end
  bf16* Ds = Qs + BQ * LD;      // dO, [BQ][LD]
  bf16* Ks = Ds + BQ * LD;      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const bf16* qb = p.q + b * p.sb[kQ] + h * p.sh[kQ];
  const bf16* kb = p.k + b * p.sb[kK] + hk * p.sh[kK];
  const bf16* vb = p.v + b * p.sb[kV] + hk * p.sh[kV];
  const bf16* ob = p.o + b * p.sb[kO] + h * p.sh[kO];
  const bf16* dob = p.dout + b * p.sb[kDO] + h * p.sh[kDO];
  bf16* dqb = p.dq + b * p.sb[kDQ] + h * p.sh[kDQ];
  const long long lrow = (static_cast<long long>(b) * p.hq + h) * p.rows;

  int n_tiles = (p.sk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q_start + BQ - 1) / BK + 1);

  stage_rows<D>(Qs, qb, p.ss[kQ], q_start, p.sq);
  stage_rows<D>(Ds, dob, p.ss[kDO], q_start, p.sq);
  stage_rows<D>(Ks, kb, p.ss[kK], 0, p.sk);
  stage_rows<D>(Vs, vb, p.ss[kV], 0, p.sk);
  tc::cp_async_commit();

  // delta = rowsum(dO o O) of this warp's rows, read from device memory
  // while the tiles land; rows g and g + 8 of the strip kept.
  const int row_lo = q_start + warp * 16;
  float dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = row_lo + i;
    float acc = 0.f;
    if (row < p.sq) {
#pragma unroll
      for (int j = 0; j < D / 64; ++j) {
        const int c = 2 * lane + 64 * j;
        const float2 x = tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(dob + row * p.ss[kDO] + c));
        const float2 y = tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(ob + row * p.ss[kO] + c));
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) p.delta[lrow + row] = acc;
    if (i == g) dlt[0] = acc;
    if (i == g + 8) dlt[1] = acc;
  }
  const float lse2[2] = {p.lse[lrow + row_lo + g] * kLog2e, p.lse[lrow + row_lo + g + 8] * kLog2e};

  // Each lane's ldmatrix addresses (bytes, shared space) at tile offset 0:
  // q and dO as A operands (this warp's rows); K and V as the B operand
  // stored [n][k] (of Q K^T and dO V^T); K as the B operand stored [k][n]
  // (of dS K), loaded transposed.
  const uint32_t q_frag = tc::smem_addr(Qs + (warp * 16 + tc::a_row(lane)) * LD + tc::a_col(lane));
  const uint32_t d_frag = tc::smem_addr(Ds + (warp * 16 + tc::a_row(lane)) * LD + tc::a_col(lane));
  const uint32_t k_frag = tc::smem_addr(Ks + tc::bt_row(lane) * LD + tc::bt_col(lane));
  const uint32_t v_frag = tc::smem_addr(Vs + tc::bt_row(lane) * LD + tc::bt_col(lane));
  const uint32_t kt_frag = tc::smem_addr(Ks + tc::bk_row(lane) * LD + tc::bk_col(lane));
  constexpr uint32_t kStage = BK * LD * sizeof(bf16);
  const float sl2 = p.scale * kLog2e;
  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      stage_rows<D>(Ks + (st ^ 1) * BK * LD, kb, p.ss[kK], (t + 1) * BK, p.sk);
      stage_rows<D>(Vs + (st ^ 1) * BK * LD, vb, p.ss[kV], (t + 1) * BK, p.sk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    const uint32_t ko = st * kStage;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      tc::ldmatrix_x4(a, q_frag + kk * 32);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bf[4];
        tc::ldmatrix_x4(bf, k_frag + ko + (np * 16 * LD + kk * 16) * 2);
        tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
        tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
      tc::ldmatrix_x4(a, d_frag + kk * 32);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bf[4];
        tc::ldmatrix_x4(bf, v_frag + ko + (np * 16 * LD + kk * 16) * 2);
        tc::mma_bf16(dp[2 * np], a, bf[0], bf[1]);
        tc::mma_bf16(dp[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // P from lse, then dS = P (dP - delta) in place of dP; masked only on
    // tiles that cross the diagonal or the end of k.
    const int k_start = t * BK;
    const bool edge = k_start + BK > p.sk || (p.causal && k_start + BK - 1 > row_lo);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = exp2f(fmaf(s[j][e], sl2, -lse2[r]));
        if (edge) {
          const int row = row_lo + g + 8 * r;
          const int col = k_start + j * 8 + 2 * t4 + (e & 1);
          if (!(col < p.sk && (!p.causal || col <= row))) pr = 0.f;
        }
        dp[j][e] = pr * (dp[j][e] - dlt[r]);
      }

    // dQ += dS K: dS rounded to bf16 and repacked in registers.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      tc::acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, kt_frag + ko + (kk * 16 * LD + dn * 16) * 2);
        tc::mma_bf16(dq[2 * dn], a, bf[0], bf[1]);
        tc::mma_bf16(dq[2 * dn + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Each warp reads only its own rows of Qs, so it writes its dQ rows there.
  bf16* tile = Qs + warp * 16 * LD;
  frag_to_smem<D>(tile, dq, p.scale, g, t4);
  __syncwarp();
  store_rows<D>(dqb, p.ss[kDQ], tile, row_lo, p.sq, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8;
  constexpr int NQ = D > 64 ? 32 : 64;  // q columns of a pass
  constexpr int NN = NQ / 8;            // its n-blocks
  static_assert(BK == kWarps * 16 && BQ % NQ == 0 && D % 64 == 0, "tile shape");

  extern __shared__ __align__(16) bf16 sm[];
  bf16* Ks = sm;                // [BK][LD]; the dK tile at the end
  bf16* Vs = Ks + BK * LD;      // [BK][LD]; the dV tile at the end
  bf16* Qs = Vs + BK * LD;      // [2][BQ][LD]
  bf16* Ds = Qs + 2 * BQ * LD;  // dO, [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(Ds + 2 * BQ * LD);  // lse, [2][BQ]
  float* Es = Ls + 2 * BQ;                                 // delta, [2][BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k_start = blockIdx.x * BK;  // the lowest kv tiles see the most q tiles: first
  const int hk = blockIdx.y, b = blockIdx.z;
  const bf16* kb = p.k + b * p.sb[kK] + hk * p.sh[kK];
  const bf16* vb = p.v + b * p.sb[kV] + hk * p.sh[kV];
  bf16* dkb = p.dk + b * p.sb[kDK] + hk * p.sh[kDK];
  bf16* dvb = p.dv + b * p.sb[kDV] + hk * p.sh[kDV];

  // Iterations over (head of the group, q tile), q tiles from the diagonal.
  const int n_qt = (p.sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? min(k_start / BQ, n_qt) : 0;
  const int per = n_qt - qt0;
  const int n_it = p.group * per;

  auto stage_q = [&](int it, int buf) {
    const int h = hk * p.group + it / per, q_start = (qt0 + it % per) * BQ;
    stage_rows<D>(Qs + buf * BQ * LD, p.q + b * p.sb[kQ] + h * p.sh[kQ], p.ss[kQ], q_start, p.sq);
    stage_rows<D>(Ds + buf * BQ * LD, p.dout + b * p.sb[kDO] + h * p.sh[kDO], p.ss[kDO], q_start,
                  p.sq);
    const long long lrow = (static_cast<long long>(b) * p.hq + h) * p.rows + q_start;
    if (tid < BQ / 4)
      tc::cp_async16(tc::smem_addr(Ls + buf * BQ + 4 * tid), p.lse + lrow + 4 * tid, 16);
    else if (tid < BQ / 2)
      tc::cp_async16(tc::smem_addr(Es + buf * BQ + 4 * (tid - BQ / 4)),
                     p.delta + lrow + 4 * (tid - BQ / 4), 16);
  };

  stage_rows<D>(Ks, kb, p.ss[kK], k_start, p.sk);
  stage_rows<D>(Vs, vb, p.ss[kV], k_start, p.sk);
  if (n_it > 0) stage_q(0, 0);
  tc::cp_async_commit();

  const int kv_lo = k_start + warp * 16;  // this warp's first kv row
  // Each lane's ldmatrix addresses at tile offset 0: K and V as A operands
  // (this warp's rows); q and dO as the B operand stored [n][k] (of K Q^T
  // and V dO^T), and stored [k][n] (of dS^T Q and P^T dO), loaded
  // transposed.
  const uint32_t k_frag = tc::smem_addr(Ks + (warp * 16 + tc::a_row(lane)) * LD + tc::a_col(lane));
  const uint32_t v_frag = tc::smem_addr(Vs + (warp * 16 + tc::a_row(lane)) * LD + tc::a_col(lane));
  const uint32_t qn_frag = tc::smem_addr(Qs + tc::bt_row(lane) * LD + tc::bt_col(lane));
  const uint32_t don_frag = tc::smem_addr(Ds + tc::bt_row(lane) * LD + tc::bt_col(lane));
  const uint32_t qk_frag = tc::smem_addr(Qs + tc::bk_row(lane) * LD + tc::bk_col(lane));
  const uint32_t dok_frag = tc::smem_addr(Ds + tc::bk_row(lane) * LD + tc::bk_col(lane));
  constexpr uint32_t kStage = BQ * LD * sizeof(bf16);
  const float sl2 = p.scale * kLog2e;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) stage_q(it + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const int q_start = (qt0 + it % per) * BQ;
    const bool edge = kv_lo + 16 > p.sk || (p.causal && kv_lo + 15 > q_start);
    const uint32_t qo = st * kStage;
    const float* lse = Ls + st * BQ;
    const float* dlt = Es + st * BQ;

#pragma unroll 1
    for (int q0 = 0; q0 < BQ; q0 += NQ) {
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, k_frag + kk * 32);
#pragma unroll
        for (int np = 0; np < NN / 2; ++np) {
          uint32_t bf[4];
          tc::ldmatrix_x4(bf, qn_frag + qo + ((q0 + np * 16) * LD + kk * 16) * 2);
          tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
        tc::ldmatrix_x4(a, v_frag + kk * 32);
#pragma unroll
        for (int np = 0; np < NN / 2; ++np) {
          uint32_t bf[4];
          tc::ldmatrix_x4(bf, don_frag + qo + ((q0 + np * 16) * LD + kk * 16) * 2);
          tc::mma_bf16(dp[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(dp[2 * np + 1], a, bf[2], bf[3]);
        }
      }

      // P^T (rows kv, columns q) from the q rows' lse, then dS^T in place
      // of dP^T.
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const int c = q0 + j * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(lse + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x, dq_ = (e & 1) ? d2.y : d2.x;
          float pr = exp2f(fmaf(s[j][e], sl2, -lq * kLog2e));
          if (edge) {
            const int kv = kv_lo + g + 8 * (e >> 1), q = q_start + c + (e & 1);
            if (!(kv < p.sk && (!p.causal || kv <= q))) pr = 0.f;
          }
          s[j][e] = pr;
          dp[j][e] = pr * (dp[j][e] - dq_);
        }
      }

      // dV += P^T dO and dK += dS^T Q, both rounded to bf16 and repacked in
      // registers; the pass's q columns are the products' k dim.
#pragma unroll
      for (int kk = 0; kk < NN / 2; ++kk) {
        uint32_t a[4];
        tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < ND / 2; ++dn) {
          uint32_t bf[4];
          tc::ldmatrix_x4_trans(bf, dok_frag + qo + ((q0 + kk * 16) * LD + dn * 16) * 2);
          tc::mma_bf16(dv[2 * dn], a, bf[0], bf[1]);
          tc::mma_bf16(dv[2 * dn + 1], a, bf[2], bf[3]);
        }
        tc::acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < ND / 2; ++dn) {
          uint32_t bf[4];
          tc::ldmatrix_x4_trans(bf, qk_frag + qo + ((q0 + kk * 16) * LD + dn * 16) * 2);
          tc::mma_bf16(dk[2 * dn], a, bf[0], bf[1]);
          tc::mma_bf16(dk[2 * dn + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Each warp reads only its own rows of Ks and Vs, so it writes its dK and
  // dV rows there (once the k and v tiles have landed, if no q tile did).
  tc::cp_async_wait<0>();
  __syncwarp();
  bf16* k_tile = Ks + warp * 16 * LD;
  bf16* v_tile = Vs + warp * 16 * LD;
  frag_to_smem<D>(k_tile, dk, p.scale, g, t4);
  frag_to_smem<D>(v_tile, dv, 1.f, g, t4);
  __syncwarp();
  store_rows<D>(dkb, p.ss[kDK], k_tile, kv_lo, p.sk, lane);
  store_rows<D>(dvb, p.ss[kDV], v_tile, kv_lo, p.sk, lane);
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

template <typename Kernel, typename P>
int run(Kernel kernel, const P& p, dim3 grid, int smem, cudaStream_t stream, const Query* query) {
  // Above 48 KB a block needs the opt-in; set it on every call, it is cheap.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  if (query) {
    *query->smem_bytes = smem;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(query->blocks_per_sm, kernel,
                                                             kThreads, smem));
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// The kernels a C entry or an occupancy query selects.
enum Which { kServing, kTrainForward, kDq, kDkdv };

template <int D>
int launch(const Params& p, int dtype, bool aligned, cudaStream_t stream, const Query* query) {
  const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, p.batch);
  if (dtype == 0)
    return run(flash_fwd_f32_kernel<D>, p, grid, int(smem_floats<D>() * sizeof(float)), stream,
               query);
  if (dtype != 1) return kUnsupported;
  return aligned
             ? run(flash_fwd_bf16_kernel<D, true>, p, grid, bf16_smem_bytes<D>(), stream, query)
             : run(flash_fwd_bf16_kernel<D, false>, p, grid, bf16_smem_bytes<D>(), stream, query);
}

int dispatch_dim(const Params& p, int dtype, int d, bool aligned, cudaStream_t stream,
                 const Query* query = nullptr) {
  switch (d) {
    case 16: return launch<16>(p, dtype, aligned, stream, query);
    case 32: return launch<32>(p, dtype, aligned, stream, query);
    case 64: return launch<64>(p, dtype, aligned, stream, query);
    case 128: return launch<128>(p, dtype, aligned, stream, query);
    default: return kUnsupported;
  }
}

// Training's kernels: the forward with lse, or the backward's dQ kernel and
// then its dK/dV kernel (with `query` set, the one `kernel` names).
template <int D>
int launch_train(int kernel, const Params& p, const BwdParams& bp, cudaStream_t stream,
                 const Query* query) {
  if (kernel == kTrainForward) {
    const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, p.batch);
    return run(flash_fwd_bf16_kernel<D, true, true>, p, grid, bf16_smem_bytes<D>(), stream,
               query);
  }
  const int smem = bwd_smem_bytes<D>();
  if (query == nullptr || kernel == kDq) {
    const dim3 grid((bp.sq + BQ - 1) / BQ, bp.hq, bp.batch);
    const int err = run(flash_bwd_dq_kernel<D>, bp, grid, smem, stream, query);
    if (err != 0 || query != nullptr) return err;
  }
  const dim3 grid((bp.sk + BK - 1) / BK, bp.hkv, bp.batch);
  return run(flash_bwd_dkdv_kernel<D>, bp, grid, smem + 4 * BQ * int(sizeof(float)), stream,
             query);
}

int dispatch_train(int kernel, int d, const Params& p, const BwdParams& bp, cudaStream_t stream,
                   const Query* query = nullptr) {
  switch (d) {
    case 64: return launch_train<64>(kernel, p, bp, stream, query);
    case 128: return launch_train<128>(kernel, p, bp, stream, query);
    default: return kUnsupported;
  }
}

// Whether a tensor's base and its first `n` strides (elements of 2 bytes)
// keep every row start 16-byte aligned, as cp.async needs.
bool aligned16(const void* ptr, const long long* strides, int n) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] % 8) return false;
  return true;
}

// Params from the C entries' arguments: 12 element strides, (batch, head,
// sequence) for q, k, v and o in that order; no lse.
Params make_params(const void* q, const void* k, const void* v, void* o, int batch, int hq,
                   int hkv, int sq, int sk, const long long* strides, float scale, int causal) {
  Params p{};
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
  return p;
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
  const Params p = make_params(q, k, v, o, batch, hq, hkv, sq, sk, strides, scale, causal);
  // cp.async needs 16-byte-aligned sources: every q, k, v row start.
  const bool aligned = aligned16(q, strides, 3) && aligned16(k, strides + 3, 3) &&
                       aligned16(v, strides + 6, 3);
  return dispatch_dim(p, dtype, d, aligned, static_cast<cudaStream_t>(stream));
}

// Training's bf16 forward, which also writes each row's log-sum-exp.
// strides as flash_attention_fwd's; `lse` (B, Hq, Sq rounded up to 64)
// contiguous fp32. Returns as flash_attention_fwd does, or -2 for a row
// start that is not 16-byte aligned.
int flash_attention_train_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int batch, int hq, int hkv, int sq, int sk, int d,
                              const long long* strides, float scale, int causal, void* stream) {
  Params p = make_params(q, k, v, o, batch, hq, hkv, sq, sk, strides, scale, causal);
  p.lse = lse;
  p.lse_rows = (sq + BQ - 1) / BQ * BQ;
  if (!(aligned16(q, strides, 3) && aligned16(k, strides + 3, 3) && aligned16(v, strides + 6, 3)))
    return kUnaligned;
  return dispatch_train(kTrainForward, d, p, BwdParams{}, static_cast<cudaStream_t>(stream));
}

// The backward: dq, dk, dv (each in its input's shape) from q, k, v, o, dout
// and the forward's lse; `delta` (the shape of lse) is scratch that the
// first kernel writes and the second reads. strides: 24 element strides,
// (batch, head, sequence) for q, k, v, o, dout, dq, dk, dv in that order.
// Returns as flash_attention_train_fwd does.
int flash_attention_train_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int batch, int hq, int hkv, int sq, int sk,
                              int d, const long long* strides, float scale, int causal,
                              void* stream) {
  BwdParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const void* ptrs[kTensors] = {q, k, v, o, dout, dq, dk, dv};
  for (int i = 0; i < kTensors; ++i) {
    p.sb[i] = strides[3 * i];
    p.sh[i] = strides[3 * i + 1];
    p.ss[i] = strides[3 * i + 2];
    if (!aligned16(ptrs[i], strides + 3 * i, 3)) return kUnaligned;
  }
  p.batch = batch;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.sq = sq;
  p.sk = sk;
  p.rows = (sq + BQ - 1) / BQ * BQ;
  p.causal = causal;
  p.scale = scale;
  return dispatch_train(kDq, d, Params{}, p, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of the kernel that `kernel` (0 serving's
// forward, at `dtype` and `aligned`; 1 training's forward; 2 the dQ kernel;
// 3 the dK/dV kernel) and `d` select, and how many of its CTAs fit on one
// SM. Returns 0 or an error code as flash_attention_fwd does.
int flash_attention_occupancy(int kernel, int dtype, int d, int aligned, int* blocks_per_sm,
                              int* smem_bytes) {
  const Query query{blocks_per_sm, smem_bytes};
  if (kernel == kServing) return dispatch_dim(Params{}, dtype, d, aligned != 0, nullptr, &query);
  if (kernel < kTrainForward || kernel > kDkdv || dtype != 1) return kUnsupported;
  return dispatch_train(kernel, d, Params{}, BwdParams{}, nullptr, &query);
}

const char* flash_attention_error_string(int code) {
  if (code == kUnsupported) return "dtype or head dim not compiled";
  if (code == kUnaligned) return "a row start is not 16-byte aligned";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
