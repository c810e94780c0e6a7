// Flash attention, forward only, for NVIDIA Hopper (sm_90a).
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
// Two kernels, chosen by dtype:
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

template <int D, bool kAsync>
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
// Launch
// --------------------------------------------------------------------------

// With `query` set, report the kernel's dynamic shared memory and how many
// of its CTAs fit on one SM instead of launching it.
struct Query {
  int* blocks_per_sm;
  int* smem_bytes;
};

template <typename Kernel>
int run(Kernel kernel, const Params& p, int smem, cudaStream_t stream, const Query* query) {
  // Above 48 KB a block needs the opt-in; set it on every call, it is cheap.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  if (query) {
    *query->smem_bytes = smem;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(query->blocks_per_sm, kernel,
                                                             kThreads, smem));
  }
  const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, p.batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <int D>
int launch(const Params& p, int dtype, bool aligned, cudaStream_t stream, const Query* query) {
  if (dtype == 0)
    return run(flash_fwd_f32_kernel<D>, p, int(smem_floats<D>() * sizeof(float)), stream, query);
  if (dtype != 1) return kUnsupported;
  return aligned ? run(flash_fwd_bf16_kernel<D, true>, p, bf16_smem_bytes<D>(), stream, query)
                 : run(flash_fwd_bf16_kernel<D, false>, p, bf16_smem_bytes<D>(), stream, query);
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

bool aligned16(const void* ptr, const long long* strides, int n) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] % 8) return false;
  return true;
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
  // cp.async needs 16-byte-aligned sources: every q, k, v row start.
  const bool aligned = aligned16(q, strides, 3) && aligned16(k, strides + 3, 3) &&
                       aligned16(v, strides + 6, 3);
  return dispatch_dim(p, dtype, d, aligned, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of the kernel that (dtype, d, aligned) selects
// and how many of its CTAs fit on one SM. Returns 0 or an error code as
// flash_attention_fwd does.
int flash_attention_occupancy(int dtype, int d, int aligned, int* blocks_per_sm,
                              int* smem_bytes) {
  const Params p{};
  const Query query{blocks_per_sm, smem_bytes};
  return dispatch_dim(p, dtype, d, aligned != 0, nullptr, &query);
}

const char* flash_attention_error_string(int code) {
  if (code == kUnsupported) return "dtype or head dim not compiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
