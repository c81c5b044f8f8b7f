// GF(2^8) matrix product for stripe encode, repair and decode on Hopper.
//
//   out[s, i, :] = XOR_j gfmul(coef[i, j], data[s, j, :])    poly 0x11D
//
// coef (m, k) uint8, data (S, k, B) uint8 -> out (S, m, B) uint8, all
// row-major and contiguous; one coefficient block is shared by all S
// stripes.
//
// Replaces the TPU kernels src/repro/kernels/gf256_matmul.py::
// gf256_matmul_batched (stripe grid, pallas_call at :126) and
// ::gf256_matmul (flat, pallas_call at :92; launched here with S = 1). The
// TPU kernels multiply bit-serially because the TPU's vector unit has no
// byte gather.
//
// What bounded the first version on an H100: it multiplied through log/exp
// tables in shared memory, one byte lookup per data byte (its log) plus one
// per data byte and output row (exp[log c + log x]). Neighbouring lanes
// looked up unrelated bytes of a 1040-byte table and collided on banks, so
// at S = 10, k = 24 each extra output row cost 0.065 ms, about 20 times its
// bytes at 3.35 TB/s: the lookups, not device memory, set its time. At
// S = 1 (the seal's flat encode) it also had too few bytes in flight: 256
// blocks of 256 threads, each with one 16-byte load ahead of its lookups.
//
// This one multiplies without lookups. Multiplication by a fixed c is
// linear over GF(2), so with the data byte x cut into the fields x[0:3],
// x[3:6] and x[6:8],
//
//   gfmul(c, x) = T0c[x & 7] ^ T1c[(x >> 3) & 7] ^ T2c[x >> 6],
//
// three tables of 8 bytes (T2c repeats its 4 entries), each held in two
// 32-bit registers. One byte permute (PRMT in its default mode) looks up
// 4 bytes at once, so a 4-byte word costs 3 PRMT and 2 LOP3 per output row,
// plus 8 operations shared by every output row to cut its selectors.
//
// What bounds it on an H100: at one output row, device memory (1.19 to
// 1.23 times the bytes bound at the repair windows with k >= 12); each
// further row adds 5 integer operations a word on the SM's 32-bit pipe
// (about 0.02 ms a row at S = 10, k = 24, against 0.003 ms of its bytes),
// so m = 4 is 1.5 to 1.7 times the bound. A short launch (k = 2, 8 KB read
// per block) is bound by each block's fixed prologue, and the seal's flat
// encode (S = 1) by latency: one wave of blocks, each lane walking all k.
//
// What the design does about it:
// * selectors in 2 or 3 operations a field: f = (word >> 3i) & 0x07070707,
//   then f + (f >> 12) (one LEA.HI; the terms share no bit) puts the fields
//   of bytes 0, 2, 1, 3 into the four nibbles PRMT reads, never setting a
//   nibble's mode bit. The sums are kept in that byte order (XOR does not
//   mind) and put back with one PRMT per output word at the store. The bit
//   a 2-bit field takes from the next byte only picks a repeat;
// * the tables of a coefficient chunk are built once per block in its
//   prologue from the exp/log table argument (a*b = exp[log a + log b],
//   log 0 landing in a zero tail), TM rows x 64 input rows x 24 bytes of
//   shared memory, read as warp-uniform broadcast loads (3 LDS.64 per input
//   and output row); the first rows' data loads are issued before the
//   prologue, so its latency hides behind them;
// * each lane owns 16 bytes of a row (uint4 loads and stores, neighbouring
//   lanes on neighbouring addresses) for all TM output rows of its m tile
//   (1, 2, 4 or 8, the smallest that covers m; a wider m walks several
//   tiles), whose sums stay in registers across the k loop, so a data byte
//   is read from device memory once per m tile; two register buffers of 2
//   rows keep the next rows' loads in flight during the arithmetic;
// * launch bounds hold each instantiation to the registers that fit as
//   many blocks a SM as it can take without a spill: 4 at TM <= 2 (64
//   registers; a short launch's prologues overlap across blocks), 2 at
//   TM >= 4 and on the byte-wise path;
// * no split of k over warps: every warp walks all k rows of its columns.
//   The seal at B = 1 MiB fills one wave (2048 warps) unsplit, and
//   splitting it 4 ways, the partial sums XORed through shared memory, was
//   1.2 times slower (the prologue is paid per block, the slices are short);
// * edges in the same kernel: a ragged B, or data/out off a 16-byte
//   boundary, take a byte-wise instantiation (one row at a time); k = 0
//   writes zeros; more than 65535 (stripe, m tile) pairs are walked by a
//   loop over blockIdx.y; k past 64 rebuilds the tables per chunk of 64.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // threads per block
constexpr int kVec = 16;                // bytes of each row a lane owns
constexpr int kWords = kVec / 4;        // 32-bit words of them
constexpr int kChunkK = 64;             // input rows whose tables sit in
                                        // shared memory at a time
constexpr int kExpSize = 1040;          // exp table: cyclic below 510, zero
                                        // above; log(0) = 512 lands there

template <int TM>
struct Shared {
  uint16_t log[256];
  uint8_t exp[kExpSize];
  uint2 tab[kChunkK][TM][3];
};

// Rows a lane loads at a time: 2 on the 16-byte path, one on the byte-wise
// one (each byte takes a register).
template <bool kAligned>
constexpr int kRows = kAligned ? 2 : 1;

// Blocks a SM must hold: 4 (64 registers) where that needs no spill, the
// 16-byte path at TM <= 2, else 2 (128 registers).
template <int TM, bool kAligned>
constexpr int kMinBlocks = kAligned && TM <= 2 ? 4 : 2;

template <bool kAligned>
__device__ __forceinline__ void load_row(uint32_t (&v)[kWords],
                                         const uint8_t* row, long long room,
                                         bool ok) {
  if constexpr (kAligned) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (ok) x = *reinterpret_cast<const uint4*>(row);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      uint32_t word = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (ok && q * 4 + b < room) {
          word |= static_cast<uint32_t>(row[q * 4 + b]) << (8 * b);
        }
      }
      v[q] = word;
    }
  }
}

// PRMT in its default mode: byte n of the result is byte (sel >> 4n) & 7 of
// {hi, lo} (bit 3 of the nibble, clear here, would replicate its sign).
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// Stores a lane's sums, put back from byte order 0, 2, 1, 3.
template <bool kAligned>
__device__ __forceinline__ void store_row(uint8_t* dst,
                                          const uint32_t (&acc)[kWords],
                                          long long room) {
  uint32_t v[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) v[q] = prmt(acc[q], 0u, 0x3120u);
  if constexpr (kAligned) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int b = 0; b < kVec; ++b) {
      if (b < room) dst[b] = static_cast<uint8_t>(v[b >> 2] >> (8 * (b & 3)));
    }
  }
}

// Loads rows i .. i+U-1 of the chunk (those below hi; the rest are zero).
template <int U, bool kAligned>
__device__ __forceinline__ void load_rows(uint32_t (&v)[U][kWords],
                                          const uint8_t* __restrict__ src,
                                          long long B, long long room, int i,
                                          int hi, bool active) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    load_row<kAligned>(v[u], src + static_cast<long long>(i + u) * B, room,
                       active && i + u < hi);
  }
}

// PRMT selectors of a field at bit 0 of each byte of x: the fields of bytes
// 0, 2, 1, 3 in nibbles 0..3 (the low half; PRMT ignores the high one),
// each nibble's mode bit clear. The two terms share no bit, so the sum is
// their OR: one LEA.HI after the mask.
__device__ __forceinline__ uint32_t selectors(uint32_t x) {
  const uint32_t f = x & 0x07070707u;
  return f + (f >> 12);
}

// acc[i] ^= gfmul(coef row i, v) for one input row whose tables are t.
template <int TM>
__device__ __forceinline__ void mul_row(uint32_t (&acc)[TM][kWords],
                                        const uint32_t (&v)[kWords],
                                        const uint2 (&t)[TM][3]) {
  uint32_t sel[3][kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
#pragma unroll
    for (int f = 0; f < 3; ++f) sel[f][q] = selectors(v[q] >> (3 * f));
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const uint2 t0 = t[i][0];
    const uint2 t1 = t[i][1];
    const uint2 t2 = t[i][2];
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      acc[i][q] ^= prmt(t0.x, t0.y, sel[0][q]) ^
                   prmt(t1.x, t1.y, sel[1][q]) ^
                   prmt(t2.x, t2.y, sel[2][q]);
    }
  }
}

template <int TM, int U>
__device__ __forceinline__ void mul_rows(uint32_t (&acc)[TM][kWords],
                                         const uint32_t (&v)[U][kWords],
                                         const Shared<TM>& sh, int i, int hi) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (i + u < hi) mul_row<TM>(acc, v[u], sh.tab[i + u]);
  }
}

// acc ^= the products of rows 0 .. hi-1 of the chunk at src, rows
// 0 .. U-1 already loaded into va. Two register buffers: the next
// U rows' loads are in flight while the current ones are multiplied.
template <int TM, bool kAligned>
__device__ __forceinline__ void accumulate(
    uint32_t (&acc)[TM][kWords], uint32_t (&va)[kRows<kAligned>][kWords],
    const Shared<TM>& sh, const uint8_t* __restrict__ src, long long B,
    long long room, int hi) {
  constexpr int U = kRows<kAligned>;
  uint32_t vb[U][kWords];
  for (int i = 0; i < hi; i += 2 * U) {
    load_rows<U, kAligned>(vb, src, B, room, i + U, hi, true);
    mul_rows<TM, U>(acc, va, sh, i, hi);
    if (i + U >= hi) break;
    load_rows<U, kAligned>(va, src, B, room, i + 2 * U, hi, true);
    mul_rows<TM, U>(acc, vb, sh, i + U, hi);
  }
}

// Builds the tables of coefficient rows i0 .. i0+tm-1 (zero for the rest of
// the tile) and input rows j0 .. j0+kc-1: word h of tab[j][i][f] holds
// gfmul(c, (v << 3f) & 0xFF) for v = 4h .. 4h+3 in its bytes.
template <int TM>
__device__ void build_tables(Shared<TM>& sh, const uint8_t* __restrict__ coef,
                             int k, int i0, int tm, int j0, int kc) {
  uint32_t* words = reinterpret_cast<uint32_t*>(sh.tab);
  for (int e = threadIdx.x; e < kc * TM * 6; e += kThreads) {
    const int w = e % 6;
    const int i = (e / 6) % TM;
    const int j = e / (6 * TM);
    const int c = i < tm ? coef[static_cast<long long>(i0 + i) * k + j0 + j]
                         : 0;
    const int lc = sh.log[c];
    const int shift = 3 * (w >> 1);
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int x = ((4 * (w & 1) + b) << shift) & 0xFF;
      word |= static_cast<uint32_t>(sh.exp[lc + sh.log[x]]) << (8 * b);
    }
    words[(j * TM + i) * 6 + w] = word;
  }
}

// One block: 8 column chunks of 512 bytes, one a warp, of block column
// blockIdx.x, for every (stripe, m tile) t = blockIdx.y, blockIdx.y +
// gridDim.y, ...
template <int TM, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks<TM, kAligned>)
gf256_matmul_kernel(const uint8_t* __restrict__ coef,
                    const uint8_t* __restrict__ data,
                    uint8_t* __restrict__ out,
                    const uint8_t* __restrict__ tables, int m, int k,
                    long long B, int S, int mtiles) {
  constexpr int U = kRows<kAligned>;
  __shared__ Shared<TM> sh;

  const long long col =
      static_cast<long long>(blockIdx.x) * kThreads * kVec +
      static_cast<long long>(threadIdx.x) * kVec;
  const bool active = col < B;

  for (int i = threadIdx.x; i < kExpSize; i += kThreads) sh.exp[i] = tables[i];
  const uint16_t* g_log = reinterpret_cast<const uint16_t*>(tables + kExpSize);
  for (int i = threadIdx.x; i < 256; i += kThreads) sh.log[i] = g_log[i];
  // The first barrier of the chunk loop publishes them.

  const long long tiles = static_cast<long long>(S) * mtiles;
  for (long long t = blockIdx.y; t < tiles; t += gridDim.y) {
    const long long s = t / mtiles;
    const int i0 = static_cast<int>(t - s * mtiles) * TM;
    const int tm = min(TM, m - i0);
    const uint8_t* src = data + s * k * B + col;

    uint32_t acc[TM][kWords];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int q = 0; q < kWords; ++q) acc[i][q] = 0u;
    }
    for (int j0 = 0; j0 < k; j0 += kChunkK) {
      const int kc = min(kChunkK, k - j0);
      const uint8_t* rows = src + static_cast<long long>(j0) * B;
      uint32_t va[U][kWords];
      load_rows<U, kAligned>(va, rows, B, B - col, 0, kc, active);
      __syncthreads();  // exp/log loaded; the last tables are read
      build_tables<TM>(sh, coef, k, i0, tm, j0, kc);
      __syncthreads();
      if (active) accumulate<TM, kAligned>(acc, va, sh, rows, B, B - col, kc);
    }

    if (!active) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (i >= tm) break;
      store_row<kAligned>(out + (s * m + i0 + i) * B + col, acc[i], B - col);
    }
  }
}

template <int TM>
int launch(const uint8_t* coef, const uint8_t* data, uint8_t* out,
           const uint8_t* tables, int m, int k, long long B, int S,
           bool aligned, cudaStream_t stream) {
  const int mtiles = (m + TM - 1) / TM;
  const long long cols = (B + kThreads * kVec - 1) / (kThreads * kVec);
  const long long tiles = static_cast<long long>(S) * mtiles;
  if (cols > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(cols),
            static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
  if (aligned) {
    gf256_matmul_kernel<TM, true><<<grid, kThreads, 0, stream>>>(
        coef, data, out, tables, m, k, B, S, mtiles);
  } else {
    gf256_matmul_kernel<TM, false><<<grid, kThreads, 0, stream>>>(
        coef, data, out, tables, m, k, B, S, mtiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
// ``tables`` is the 1040-byte exp table followed by 256 uint16 logs (the
// wrapper builds and caches it per device). Empty shapes launch nothing;
// k = 0 writes zeros.
extern "C" int gf256_matmul_launch(const void* coef, const void* data,
                                   void* out, const void* tables, int m,
                                   int k, long long B, int S, void* stream) {
  if (m <= 0 || S <= 0 || B <= 0) return 0;
  const bool aligned = B % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const uint8_t*>(coef);
  auto d = static_cast<const uint8_t*>(data);
  auto o = static_cast<uint8_t*>(out);
  auto tb = static_cast<const uint8_t*>(tables);
  if (m <= 1) return launch<1>(c, d, o, tb, m, k, B, S, aligned, st);
  if (m <= 2) return launch<2>(c, d, o, tb, m, k, B, S, aligned, st);
  if (m <= 4) return launch<4>(c, d, o, tb, m, k, B, S, aligned, st);
  return launch<8>(c, d, o, tb, m, k, B, S, aligned, st);
}
