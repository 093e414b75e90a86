// Profile chain DP for NVIDIA Hopper, called from JAX through the FFI.
//
// One thread block aligns one query against its column profile.  The
// query's M lanes are spread over the block's threads, E consecutive
// lanes per thread, and the loop over profile columns runs inside the
// kernel with the V/D rows in registers.  Per column the block:
//   * computes the substitution costs from the profile column (four
//     base fractions + a gap term) and the query masks, so the
//     (B, C, M) cost tensor never exists in device memory;
//   * takes the one-lane shifts of V, U and I with warp shuffles;
//   * solves the insertion track with a block-wide exclusive
//     prefix-min (warp shuffle scan + one shared-memory exchange per
//     column, double-buffered so one __syncthreads() per column
//     suffices);
//   * writes one uint8 backpointer row in the compact chain layout
//       bits 0-1  V choice (0 edge, 1 match, 2 deletion, 3 insertion)
//       bit  2    deletion opened here
//       bit  3    insertion opened here
//     which ops/profile.chain_traceback_log reads;
//   * tracks the two end candidates (last query base over columns,
//     every query base at the last real column).
// Columns at or past a query's real column count are skipped: the
// traceback never reads their backpointer rows.
//
// Arithmetic follows ops/profile.chain_dp operation for operation, in
// round-to-nearest intrinsics that the compiler never contracts into
// FMAs, so that the kernel and the XLA reference see the same f32
// values.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kBig = 1e6f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}

template <int E>
__global__ void __launch_bounds__(1024)
    chain_dp_kernel(const float4* __restrict__ freqs,
                    const float* __restrict__ gap,
                    const uint8_t* __restrict__ qmask,
                    const int32_t* __restrict__ lens, int n_cols,
                    int m_pad, float go, float ge, float m_mm, float mm,
                    uint8_t* __restrict__ bp,
                    int32_t* __restrict__ best_c,
                    int32_t* __restrict__ best_i,
                    float* __restrict__ raw) {
  // per-warp scan exchange, double-buffered by column parity
  __shared__ float s_tot[2][32];
  __shared__ float s_x[2][32];
  __shared__ float s_u[2][32];
  __shared__ float s_red_v[32];
  __shared__ int s_red_i[32];
  __shared__ float s_b1v;
  __shared__ int s_b1j;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int i0 = t * E;
  const int qlen = lens[2 * b];
  const int cr = min(lens[2 * b + 1], n_cols);
  const float4* fr_b = freqs + static_cast<size_t>(b) * n_cols;
  const float* gap_b = gap + static_cast<size_t>(b) * n_cols;
  uint8_t* bp_b = bp + static_cast<size_t>(b) * n_cols * m_pad;

  if (t == 0) {
    s_b1v = kBig;
    s_b1j = 0;
  }
  __syncthreads();

  // query profile weights: w[k][e] = bit_k * inv, qs = cnt * inv
  float w0[E], w1[E], w2[E], w3[E], qs[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = qmask[static_cast<size_t>(b) * m_pad + i0 + e] & 0xF;
    const float b0 = static_cast<float>(q & 1);
    const float b1 = static_cast<float>((q >> 1) & 1);
    const float b2 = static_cast<float>((q >> 2) & 1);
    const float b3 = static_cast<float>((q >> 3) & 1);
    const float cnt = fadd(fadd(fadd(b0, b1), b2), b3);
    const float inv = cnt > 0.f ? __fdiv_rn(1.f, fmaxf(cnt, 1.f)) : 0.f;
    w0[e] = fmul(b0, inv);
    w1[e] = fmul(b1, inv);
    w2[e] = fmul(b2, inv);
    w3[e] = fmul(b3, inv);
    qs[e] = fmul(cnt, inv);
  }
  // the thread and slot that hold query base qlen-1 (end candidate 1)
  const int own = (qlen >= 1 && (qlen - 1) / E == t) ? (qlen - 1) % E : -1;

  float V[E], D[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    V[e] = kBig;
    D[e] = kBig;
  }
  float vleft = kBig;  // V[j-1][i0-1], kept by lane 0 of each warp
  float b1v = kBig;
  int b1j = 0;
  float b2v = kBig;
  int b2i = 0;

  float4 f_next = cr > 0 ? __ldg(&fr_b[0]) : make_float4(0.f, 0.f, 0.f, 0.f);
  float g_next = cr > 0 ? __ldg(&gap_b[0]) : 0.f;

  for (int j = 0; j < cr; ++j) {
    const float4 f = f_next;
    const float g = g_next;
    if (j + 1 < cr) {
      f_next = __ldg(&fr_b[j + 1]);
      g_next = __ldg(&gap_b[j + 1]);
    }
    const int p = j & 1;
    const float occ = fadd(fadd(fadd(f.x, f.y), f.z), f.w);
    const float mmocc = fmul(mm, occ);
    const float dgo = fmul(go, occ);
    const float dge = fmul(ge, occ);

    // left neighbour of this thread's first lane in the previous row
    float vl = __shfl_up_sync(kFull, V[E - 1], 1);
    if (lane == 0) vl = (t == 0) ? kBig : vleft;

    float U[E], loc[E];
    uint8_t code[E];
    bool dsel[E];
    float run = INFINITY;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + e;
      const float base = (j == 0 || i == 0) ? 1.f : kBig;
      const float d_open = fadd(V[e], dgo);
      const float d_ext = fadd(D[e], dge);
      const float dmin = fminf(d_open, d_ext);
      dsel[e] = d_open < d_ext;
      D[e] = fminf(base, dmin);
      const float dot =
          fadd(fadd(fadd(fmul(f.x, w0[e]), fmul(f.y, w1[e])), fmul(f.z, w2[e])),
               fmul(f.w, w3[e]));
      const float sub = fadd(fadd(fmul(m_mm, dot), fmul(mmocc, qs[e])), g);
      const float vprev = (e == 0) ? vl : V[e - 1];
      const float mc = fadd(vprev, sub);
      float u = base;
      uint8_t c = 0;
      if (dmin < u) {
        u = dmin;
        c = 2;
      }
      if (mc < u) {
        u = mc;
        c = 1;
      }
      U[e] = u;
      code[e] = c;
      const float cand =
          fsub(fadd(u, go), fmul(fadd(static_cast<float>(i), 1.f), ge));
      run = fminf(run, cand);
      loc[e] = run;
    }

    // warp-inclusive and warp-exclusive prefix-min of the thread sums
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = fminf(incl, y);
    }
    float wexcl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) wexcl = INFINITY;
    if (lane == 31) {
      s_tot[p][warp] = incl;
      s_x[p][warp] = (E > 1) ? fminf(wexcl, loc[E > 1 ? E - 2 : 0]) : wexcl;
      s_u[p][warp] = U[E - 1];
    }
    __syncthreads();
    float before = INFINITY;   // min over the warps left of this one
    float before2 = INFINITY;  // ... left of the previous warp
    for (int w = 0; w < warp; ++w) {
      const float tv = s_tot[p][w];
      if (w + 1 < warp) before2 = fminf(before2, tv);
      before = fminf(before, tv);
    }
    const float pre = fminf(before, wexcl);

    float I[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float ex = (e == 0) ? pre : fminf(pre, loc[e > 0 ? e - 1 : 0]);
      I[e] = fadd(fminf(ex, 1.f), fmul(static_cast<float>(i0 + e), ge));
    }
    float ileft = __shfl_up_sync(kFull, I[E - 1], 1);
    float uleft = __shfl_up_sync(kFull, U[E - 1], 1);
    if (lane == 0) {
      if (t == 0) {
        ileft = kBig;
        uleft = kBig;
      } else {
        // recompute the previous warp's last I exactly as its owner did
        const float ex = fminf(before2, s_x[p][warp - 1]);
        ileft = fadd(fminf(ex, 1.f), fmul(static_cast<float>(i0 - 1), ge));
        uleft = s_u[p][warp - 1];
        vleft = (ileft <= uleft) ? ileft : uleft;
      }
    }

    uint8_t* row = bp_b + static_cast<size_t>(j) * m_pad + i0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float ip = (e == 0) ? ileft : I[e > 0 ? e - 1 : 0];
      const float up = (e == 0) ? uleft : U[e > 0 ? e - 1 : 0];
      const bool opened = (fadd(up, go) <= fadd(ip, ge)) ||
                          (fadd(I[e], 1e-4f) < fadd(ip, ge));
      const bool take_i = I[e] <= U[e];
      V[e] = take_i ? I[e] : U[e];
      const int c = take_i ? 3 : code[e];
      row[e] = static_cast<uint8_t>(c | (dsel[e] ? 4 : 0) | (opened ? 8 : 0));
    }

#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e == own && V[e] < b1v) {
        b1v = V[e];
        b1j = j;
      }
    }

    if (j == cr - 1) {
      // end candidate 2: lowest-index minimum of V over i < qlen
      float lv = INFINITY;
      int li = 0x7fffffff;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float v = (i0 + e < qlen) ? V[e] : kBig;
        if (v < lv) {
          lv = v;
          li = i0 + e;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(kFull, lv, o);
        const int oi = __shfl_down_sync(kFull, li, o);
        if (ov < lv || (ov == lv && oi < li)) {
          lv = ov;
          li = oi;
        }
      }
      if (lane == 0) {
        s_red_v[warp] = lv;
        s_red_i[warp] = li;
      }
      __syncthreads();
      if (t == 0) {
        for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
          const float ov = s_red_v[w];
          const int oi = s_red_i[w];
          if (ov < lv || (ov == lv && oi < li)) {
            lv = ov;
            li = oi;
          }
        }
        b2v = lv;
        b2i = li;
      }
    }
  }

  if (own >= 0) {
    s_b1v = b1v;
    s_b1j = b1j;
  }
  __syncthreads();
  if (t == 0) {
    const float v1 = s_b1v;
    const int j1 = s_b1j;
    const bool use2 = b2v < v1;
    best_c[b] = use2 ? cr - 1 : j1;
    best_i[b] = use2 ? b2i : qlen - 1;
    raw[b] = use2 ? b2v : v1;
  }
}

template <int E>
cudaError_t launch(cudaStream_t stream, int n_blocks, int n_threads,
                   const float4* freqs, const float* gap,
                   const uint8_t* qmask, const int32_t* lens, int n_cols,
                   int m_pad, float go, float ge, float m_mm, float mm,
                   uint8_t* bp, int32_t* best_c, int32_t* best_i,
                   float* raw) {
  void* args[] = {&freqs, &gap,  &qmask, &lens, &n_cols,
                  &m_pad, &go,   &ge,    &m_mm, &mm,
                  &bp,    &best_c, &best_i, &raw};
  return cudaLaunchKernel(reinterpret_cast<const void*>(&chain_dp_kernel<E>),
                          dim3(n_blocks), dim3(n_threads), args, 0, stream);
}

ffi::Error ChainDpImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> freqs,
                       ffi::Buffer<ffi::F32> gap,
                       ffi::Buffer<ffi::U8> qmask,
                       ffi::Buffer<ffi::S32> lens, float go, float ge,
                       float m_mm, float mm, int32_t per_thread,
                       ffi::ResultBuffer<ffi::U8> bp,
                       ffi::ResultBuffer<ffi::S32> best_c,
                       ffi::ResultBuffer<ffi::S32> best_i,
                       ffi::ResultBuffer<ffi::F32> raw) {
  const auto fd = freqs.dimensions();
  const auto qd = qmask.dimensions();
  if (fd.size() != 3 || fd[2] != 4 || qd.size() != 2 || qd[0] != fd[0]) {
    return ffi::Error::InvalidArgument(
        "chain_dp: expected freqs (B, C, 4) and qmask (B, M)");
  }
  const int n_blocks = static_cast<int>(fd[0]);
  const int n_cols = static_cast<int>(fd[1]);
  const int m_pad = static_cast<int>(qd[1]);
  const int E = per_thread;
  if (E <= 0 || m_pad % (32 * E) != 0 || m_pad / E > 1024) {
    return ffi::Error::InvalidArgument(
        "chain_dp: M must be a multiple of 32 * per_thread with at most "
        "1024 threads per block");
  }
  const int n_threads = m_pad / E;
  if (n_blocks == 0) return ffi::Error::Success();
  const float4* f4 = reinterpret_cast<const float4*>(freqs.typed_data());
  cudaError_t err;
#define SINA_CHAIN_DP_CASE(N)                                               \
  case N:                                                                   \
    err = launch<N>(stream, n_blocks, n_threads, f4, gap.typed_data(),      \
                    qmask.typed_data(), lens.typed_data(), n_cols, m_pad,   \
                    go, ge, m_mm, mm, bp->typed_data(),                     \
                    best_c->typed_data(), best_i->typed_data(),             \
                    raw->typed_data());                                     \
    break;
  switch (E) {
    SINA_CHAIN_DP_CASE(1)
    SINA_CHAIN_DP_CASE(2)
    SINA_CHAIN_DP_CASE(4)
    SINA_CHAIN_DP_CASE(8)
    SINA_CHAIN_DP_CASE(16)
    default:
      return ffi::Error::InvalidArgument(
          "chain_dp: per_thread must be 1, 2, 4, 8 or 16");
  }
#undef SINA_CHAIN_DP_CASE
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("chain_dp launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SinaChainDp, ChainDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<float>("go")
                                  .Attr<float>("ge")
                                  .Attr<float>("m_mm")
                                  .Attr<float>("mm")
                                  .Attr<int32_t>("per_thread")
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());
