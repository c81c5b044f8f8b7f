// GF(2^8) matrix product for stripe encode, repair and decode on Hopper.
//
//   out[s, i, :] = XOR_j gfmul(coef[i, j], data[s, j, :])    poly 0x11D
//
// coef (m, k) uint8, data (S, k, B) uint8 -> out (S, m, B) uint8, all
// row-major and contiguous; one coefficient block is shared by all S
// stripes.
//
// Replaces the TPU kernels src/repro/kernels/gf256_matmul.py::
// gf256_matmul_batched (stripe grid) and ::gf256_matmul (flat; launched
// here with S = 1). The TPU kernels multiply bit-serially because the
// TPU's vector unit has no byte gather; Hopper has shared-memory lookups,
// so this kernel multiplies through log/exp tables instead:
// a*b = exp[log a + log b], with log(0) mapped into a zero tail of the exp
// table, so a zero coefficient or a zero byte gives zero with no branch.
//
// What bounds it on an H100: the product must move S*(k+m)*B bytes, which
// at 3.35 TB/s is the floor. Its real limit in this first version is more
// likely the shared-memory lookups: S*k*B log lookups plus S*m*k*B exp
// lookups, one byte each, with bank conflicts wherever neighbouring
// threads hit different words of one bank.
//
// What the design does about it:
// * each thread owns a 16-byte column chunk of one stripe (uint4 loads and
//   stores, neighbouring threads on neighbouring addresses), so every data
//   byte is read from device memory once per m tile and written once;
// * a data byte's log is looked up once and reused for all m output rows,
//   whose sums stay in registers across the whole k loop;
// * the m tile (1, 2, 4 or 8 rows) is the smallest that covers m, so a
//   single-block repair (m = 1) does no lookups for padding rows; wider m
//   (a full decode reaches m = k) walks several tiles;
// * the tables take 1.5 KB of shared memory and the coefficient logs
//   TM * 512 bytes, so many blocks fit on each SM;
// * a ragged B tail (B not a multiple of 16, or unaligned pointers) takes
//   a byte-wise path in the same kernel: no padding, no extra copies.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kVec = 16;        // bytes of each row that one thread owns
constexpr int kChunkK = 256;    // input rows whose coefficient logs sit in
                                // shared memory at a time
constexpr int kExpSize = 1040;  // exp table: cyclic below 510, zero above
constexpr int kLogZero = 512;   // log(0); a sum with it lands in the zero tail

template <int TM, bool kAligned>
__global__ void __launch_bounds__(kThreads)
gf256_matmul_kernel(const uint8_t* __restrict__ coef,
                    const uint8_t* __restrict__ data,
                    uint8_t* __restrict__ out,
                    const uint8_t* __restrict__ tables,
                    int m, int k, long long B, int S, int mtiles) {
  __shared__ uint8_t s_exp[kExpSize];
  __shared__ uint16_t s_log[256];
  __shared__ uint16_t s_clog[TM * kChunkK];

  for (int i = threadIdx.x; i < kExpSize; i += kThreads) s_exp[i] = tables[i];
  const uint16_t* g_log = reinterpret_cast<const uint16_t*>(tables + kExpSize);
  for (int i = threadIdx.x; i < 256; i += kThreads) s_log[i] = g_log[i];
  // The first __syncthreads of the chunk loop publishes the tables.

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  const bool active = col < B;
  const int tiles = S * mtiles;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int s = t / mtiles;
    const int i0 = (t - s * mtiles) * TM;
    const int tm = min(TM, m - i0);
    const uint8_t* src = data + static_cast<long long>(s) * k * B + col;

    uint32_t acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0u;
    }

    for (int j0 = 0; j0 < k; j0 += kChunkK) {
      const int kc = min(kChunkK, k - j0);
      __syncthreads();  // tables loaded; the previous chunk's logs are done
      for (int e = threadIdx.x; e < TM * kc; e += kThreads) {
        const int i = e / kc;
        const int j = e - i * kc;
        s_clog[i * kChunkK + j] =
            i < tm ? s_log[coef[static_cast<long long>(i0 + i) * k + j0 + j]]
                   : static_cast<uint16_t>(kLogZero);
      }
      __syncthreads();
      if (!active) continue;

      for (int j = 0; j < kc; ++j) {
        const uint8_t* row = src + static_cast<long long>(j0 + j) * B;
        uint32_t w[4];
        if (kAligned) {
          const uint4 v = *reinterpret_cast<const uint4*>(row);
          w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t word = 0u;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              if (col + q * 4 + b < B) {
                word |= static_cast<uint32_t>(row[q * 4 + b]) << (8 * b);
              }
            }
            w[q] = word;
          }
        }
        uint32_t l[kVec];
#pragma unroll
        for (int b = 0; b < kVec; ++b) {
          l[b] = s_log[(w[b >> 2] >> (8 * (b & 3))) & 0xFFu];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const uint32_t lc = s_clog[i * kChunkK + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[i][q] ^= static_cast<uint32_t>(s_exp[lc + l[4 * q]])
                       | static_cast<uint32_t>(s_exp[lc + l[4 * q + 1]]) << 8
                       | static_cast<uint32_t>(s_exp[lc + l[4 * q + 2]]) << 16
                       | static_cast<uint32_t>(s_exp[lc + l[4 * q + 3]]) << 24;
          }
        }
      }
    }

    if (!active) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (i >= tm) break;
      uint8_t* dst = out + (static_cast<long long>(s) * m + i0 + i) * B + col;
      if (kAligned) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int b = 0; b < kVec; ++b) {
          if (col + b < B) {
            dst[b] = static_cast<uint8_t>(acc[i][b >> 2] >> (8 * (b & 3)));
          }
        }
      }
    }
  }
}

template <int TM>
void launch_tile(bool aligned, dim3 grid, cudaStream_t stream,
                 const uint8_t* coef, const uint8_t* data, uint8_t* out,
                 const uint8_t* tables, int m, int k, long long B, int S,
                 int mtiles) {
  if (aligned) {
    gf256_matmul_kernel<TM, true><<<grid, kThreads, 0, stream>>>(
        coef, data, out, tables, m, k, B, S, mtiles);
  } else {
    gf256_matmul_kernel<TM, false><<<grid, kThreads, 0, stream>>>(
        coef, data, out, tables, m, k, B, S, mtiles);
  }
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// ``tables`` is the 1040-byte exp table followed by 256 uint16 logs (the
// wrapper builds and caches it per device). Empty shapes launch nothing.
extern "C" int gf256_matmul_launch(const void* coef, const void* data,
                                   void* out, const void* tables, int m,
                                   int k, long long B, int S, void* stream) {
  if (m <= 0 || S <= 0 || B <= 0) return 0;
  const int tm = m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8;
  const int mtiles = (m + tm - 1) / tm;
  const bool aligned = B % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per_block = static_cast<long long>(kThreads) * kVec;
  const long long tiles = static_cast<long long>(S) * mtiles;
  dim3 grid(static_cast<unsigned>((B + per_block - 1) / per_block),
            static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const uint8_t*>(coef);
  auto d = static_cast<const uint8_t*>(data);
  auto o = static_cast<uint8_t*>(out);
  auto tb = static_cast<const uint8_t*>(tables);
  switch (tm) {
    case 1: launch_tile<1>(aligned, grid, st, c, d, o, tb, m, k, B, S, mtiles); break;
    case 2: launch_tile<2>(aligned, grid, st, c, d, o, tb, m, k, B, S, mtiles); break;
    case 4: launch_tile<4>(aligned, grid, st, c, d, o, tb, m, k, B, S, mtiles); break;
    default: launch_tile<8>(aligned, grid, st, c, d, o, tb, m, k, B, S, mtiles); break;
  }
  return static_cast<int>(cudaGetLastError());
}
