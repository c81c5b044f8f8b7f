// GF(2) bitmatrix product as a mod-2 integer matmul on the tensor cores
// (the mxu backend) on Hopper.
//
//   out[s] = repack( (bm (R8, K8) @ bits(packets[s]) (K8, 8P)) & 1 )
//
// bm (R8, K8) uint8 (any nonzero byte is a one), packets (S, K8, P) uint8
// -> out (S, R8, P) uint8, all row-major and contiguous. bits() unpacks
// packed byte p of a row into its 8 bit columns and repack() is its
// inverse, so this is the same function as bitmatrix_encode.cu: an XOR sum
// over GF(2) is an ordinary sum taken mod 2.
//
// Replaces the TPU kernels src/repro/kernels/bitmatrix_encode.py::
// mod2_matmul_encode_batched (stripe grid) and ::mod2_matmul_encode (flat;
// launched here with S = 1), which run the product on the MXU in bf16 with
// a float32 accumulator. Here it is warp-level
// mma.sync.m16n8k32.u8.u8.s32: 0/1 bitmatrix rows as A, masked packet
// bytes as B, int32 sums (exact, and only one bit of each is kept).
//
// What bounds it on an H100: the product must move S*(K8+R8)*P bytes at
// 3.35 TB/s, and its int8 work, 2*S*R8'*K8'*8P operations (R8' the rows
// padded to 16 or 32, K8' the depth padded to 32), is below that at 1,979
// TOPS for every repair and seal shape. So bytes bound it in principle; in
// practice the unpack and repack make it bound by the SM's 32-bit integer
// issue rate (PERF.md). The design keeps that work small and in registers:
//
// * Columns are ordered so that column g of MMA tile (q, b) is bit b of
//   packed byte p0 + 4g + q. A lane (g = lane/4, t = lane%4) reads one
//   32-bit word at byte p0 + 4g from each of its packet rows 4t..4t+3 and
//   16+4t..16+4t+3 of a 32-deep k step. Three __byte_perm give it byte q of
//   its four rows, one row a byte, and its B register for tile (q, b) is
//   that word & (0x01010101 << b): one AND, none for b = 0. The int32 sum
//   is then 2^b times the count plus higher multiples, so its bit b is the
//   parity: no shift back is needed.
// * Over q = 0..3 and b = 0..7 the lane's sums hold every bit of packed
//   bytes p0+8t .. p0+8t+7 of output rows g and g+8, so the repack is one
//   AND-OR a bit in its own registers and each row is one 8-byte store.
//   Each q's first MMA starts from zero, so sums are never cleared.
// * A warp owns 32 packed bytes of one stripe at a time and walks a
//   persistent grid (about one wave of blocks) over (stripe, 32-byte tile)
//   work items; a block's warps take neighbouring tiles. Per item it loads
//   every packet word of up to 6 k steps (K8 <= 192, the main path) into
//   registers before its first MMA, then runs q = 0..3 (a loop, so the
//   code stays small) with 8 tiles x 4 sums per 16-row group. A deeper K8
//   walks chunks of 6 k steps, reloaded (from L1/L2) for each q.
// * The bitmatrix is built once per block into A fragments in shared
//   memory (0/1 bytes, zero past R8 and K8), one 16-byte read per lane per
//   k step. One or two 16-row groups share each B fragment (R8 <= 16: one;
//   else two); a wider R8 walks pairs of groups on gridDim.y, re-reading
//   the packets. A bitmatrix whose fragments pass 64 KB builds them from
//   bm at each use instead, out of line.
// * Edges stay in the kernel: k steps past K8 are skipped and rows past K8
//   load as zero; rows past R8 are neither repacked nor stored; a P that is
//   not a multiple of 8, or pointers off 4-byte (packets) or 8-byte (out)
//   alignment, take a byte-wise load and store instantiation. K8 = 0
//   writes zeros (a memset).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileP = 32;              // packed bytes a warp owns per item
constexpr int kKS = 6;                  // 32-deep k steps held in registers
constexpr int kMaxSmemA = 64 * 1024;    // A fragments held in shared memory

// Four bitmatrix bytes (row, k..k+3) as 0/1 bytes, zero past R8 and K8.
__device__ __forceinline__ uint32_t bm_word(const uint8_t* bm, int r8, int k8,
                                            int row, int k) {
  uint32_t w = 0u;
  if (row < r8) {
    const uint8_t* src = bm + static_cast<long long>(row) * k8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k + i < k8 && src[k + i] != 0) w |= 1u << (8 * i);
    }
  }
  return w;
}

// This lane's A fragment of rows r0..r0+15 and depth k0..k0+31: registers
// (row g, k 4t..), (row g+8, k 4t..), (row g, k 16+4t..), (row g+8, 16+4t..).
__device__ __forceinline__ uint4 a_fragment(const uint8_t* bm, int r8, int k8,
                                            int r0, int k0, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  return make_uint4(bm_word(bm, r8, k8, r0 + g, k0 + 4 * t),
                    bm_word(bm, r8, k8, r0 + g + 8, k0 + 4 * t),
                    bm_word(bm, r8, k8, r0 + g, k0 + 16 + 4 * t),
                    bm_word(bm, r8, k8, r0 + g + 8, k0 + 16 + 4 * t));
}

// a_fragment out of line, for the rare bitmatrix too deep for shared
// memory: the hot loop keeps only a call.
__device__ __noinline__ uint4 a_fragment_global(const uint8_t* bm, int r8,
                                                int k8, int r0, int k0,
                                                int lane) {
  return a_fragment(bm, r8, k8, r0, k0, lane);
}

// c = A (16x32 u8) * B (32x8 u8) + (first ? 0 : c), int32 sums.
__device__ __forceinline__ void mma_u8(uint32_t (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1, bool first) {
  if (first) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "r"(0));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
  }
}

// Byte q of x0..x3 (``sel`` = q | (q + 4) << 4), x_i's in byte i.
__device__ __forceinline__ uint32_t gather_byte(uint32_t x0, uint32_t x1,
                                                uint32_t x2, uint32_t x3,
                                                uint32_t sel) {
  return __byte_perm(__byte_perm(x0, x1, sel), __byte_perm(x2, x3, sel),
                     0x5410);
}

// Packed bytes p..p+3 of one packet row, zero past P.
template <bool kAligned>
__device__ __forceinline__ uint32_t packet_word(const uint8_t* row,
                                                long long p, long long P) {
  if (kAligned) {  // P % 8 == 0, so a word is either whole or past P
    return p < P ? __ldg(reinterpret_cast<const unsigned int*>(row + p)) : 0u;
  }
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (p + i < P) w |= static_cast<uint32_t>(__ldg(row + p + i)) << (8 * i);
  }
  return w;
}

// The words of k steps c*kKS .. c*kKS+5 for this lane: rows 4t..4t+3 and
// 16+4t..16+4t+3 of each (src is the stripe's row 4t), zero past K8. k
// steps wholly past K8 are not loaded (and never multiplied).
template <bool kAligned>
__device__ __forceinline__ void load_chunk(uint32_t (&w)[kKS][8],
                                           const uint8_t* src, int c, int t,
                                           int k8, long long pl, long long P) {
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    const int k0 = (c * kKS + ks) * 32;
    if (k0 < k8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 16 * h + i;  // row k + 4t
          w[ks][4 * h + i] =
              k + 4 * t < k8 ? packet_word<kAligned>(src + k * P, pl, P) : 0u;
        }
      }
    }
  }
}

// Blocks an SM must hold, which caps registers at 65536 / (128 * n): four
// (128) for one row group with word loads, down to two (255) for two row
// groups with byte loads, so that no instantiation spills.
template <int MG, bool kAligned>
constexpr int min_blocks() {
  return MG == 1 ? (kAligned ? 4 : 3) : (kAligned ? 3 : 2);
}

template <int MG, bool kAligned>
__global__ void __launch_bounds__(kThreads, (min_blocks<MG, kAligned>()))
mod2_matmul_kernel(const uint8_t* __restrict__ bm,
                   const uint8_t* __restrict__ packets,
                   uint8_t* __restrict__ out, int r8, int k8, long long P,
                   int S, int rpairs, int a_shared) {
  extern __shared__ uint4 s_a[];  // [MG][nks][32 lanes]
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nks = (k8 + 31) / 32;  // >= 1: K8 = 0 is a memset
  const int nchunks = (nks + kKS - 1) / kKS;
  const long long tiles = (P + kTileP - 1) / kTileP;
  const long long items = tiles * S;
  const long long warp0 =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;

  for (int rp = blockIdx.y; rp < rpairs; rp += gridDim.y) {
    const int rbase = rp * 16 * MG;
    if (a_shared) {
      __syncthreads();  // the previous row pair's fragments are read out
      for (int e = threadIdx.x; e < MG * nks * 32; e += kThreads) {
        const int frag = e >> 5;
        s_a[e] = a_fragment(bm, r8, k8, rbase + 16 * (frag / nks),
                            32 * (frag % nks), e & 31);
      }
      __syncthreads();
    }
    // Sum register r of group mg holds row rbase + 16 mg + g (r = 0, 1) or
    // that + 8 (r = 2, 3); a half wholly past R8 is not repacked.
    bool live[MG][2];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      live[mg][0] = rbase + 16 * mg < r8;
      live[mg][1] = rbase + 16 * mg + 8 < r8;
    }
    for (long long item = warp0; item < items; item += wstride) {
      const long long s = item / tiles;
      const long long p0 = (item - s * tiles) * kTileP;
      const long long pl = p0 + 4 * g;  // this lane's word in each row
      const uint8_t* src = packets + (s * k8 + 4 * t) * P;
      uint32_t w[kKS][8];
      uint32_t o[MG][4];
#pragma unroll
      for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
        for (int r = 0; r < 4; ++r) o[mg][r] = 0u;
      }
      load_chunk<kAligned>(w, src, 0, t, k8, pl, P);
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        const uint32_t sel = q | ((q + 4) << 4);
        uint32_t acc[MG][8][4];
        for (int c = 0; c < nchunks; ++c) {
          // Chunk 0 stays in w; a deeper K8 reloads its chunks for each q.
          if (nchunks > 1 && (q > 0 || c > 0)) {
            load_chunk<kAligned>(w, src, c, t, k8, pl, P);
          }
#pragma unroll
          for (int ks = 0; ks < kKS; ++ks) {
            const int kstep = c * kKS + ks;
            if (kstep < nks) {
              const bool first = ks == 0 && c == 0;
              uint4 a[MG];
#pragma unroll
              for (int mg = 0; mg < MG; ++mg) {
                a[mg] = a_shared ? s_a[(mg * nks + kstep) * 32 + lane]
                                 : a_fragment_global(bm, r8, k8,
                                                     rbase + 16 * mg,
                                                     32 * kstep, lane);
              }
              const uint32_t y =
                  gather_byte(w[ks][0], w[ks][1], w[ks][2], w[ks][3], sel);
              const uint32_t z =
                  gather_byte(w[ks][4], w[ks][5], w[ks][6], w[ks][7], sel);
#pragma unroll
              for (int b = 0; b < 8; ++b) {
                // For b = 0 the whole bytes do: bit 0 of the sum is the
                // parity of their bit 0 all the same.
                const uint32_t m = b == 0 ? 0xFFFFFFFFu : 0x01010101u << b;
#pragma unroll
                for (int mg = 0; mg < MG; ++mg) {
                  mma_u8(acc[mg][b], a[mg], y & m, z & m, first);
                }
              }
            }
          }
        }
        // Bit b of tile (q, b)'s sum is the parity of bit b of packed byte
        // p0 + 8t + q (registers 0, 2) or p0 + 8t + 4 + q (1, 3).
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (live[mg][r >> 1]) {
              uint32_t v = 0u;
#pragma unroll
              for (int b = 0; b < 8; ++b) v |= acc[mg][b][r] & (1u << b);
              o[mg][r] |= v << (8 * q);
            }
          }
        }
      }
      // Row g (registers 0, 1) and g+8 (2, 3): 8 bytes at p0 + 8t.
      const long long pb = p0 + 8 * t;
#pragma unroll
      for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + 16 * mg + 8 * h + g;
          if (row >= r8 || pb >= P) continue;
          uint8_t* dst = out + (s * r8 + row) * P + pb;
          if (kAligned) {
            *reinterpret_cast<uint2*>(dst) =
                make_uint2(o[mg][2 * h], o[mg][2 * h + 1]);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (pb + j < P) {
                dst[j] = static_cast<uint8_t>(o[mg][2 * h + (j >> 2)] >>
                                              (8 * (j & 3)));
              }
            }
          }
        }
      }
    }
  }
}

template <int MG, bool kAligned>
int launch(const uint8_t* bm, const uint8_t* packets, uint8_t* out, int r8,
           int k8, long long P, int S, cudaStream_t stream) {
  auto kernel = mod2_matmul_kernel<MG, kAligned>;
  const long long a_bytes =
      static_cast<long long>(MG) * ((k8 + 31) / 32) * 32 * sizeof(uint4);
  const bool a_shared = a_bytes <= kMaxSmemA;
  const int smem = a_shared ? static_cast<int>(a_bytes) : 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // About one wave: row pairs on y, work items strided over x.
  const int rpairs = (r8 + 16 * MG - 1) / (16 * MG);
  const long long items = (P + kTileP - 1) / kTileP * S;
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int gy = rpairs < 65535 ? rpairs : 65535;
  long long gx = (wave + gy - 1) / gy;
  const long long need = (items + kWarps - 1) / kWarps;
  if (gx > need) gx = need;
  kernel<<<dim3(static_cast<unsigned>(gx), gy), kThreads, smem, stream>>>(
      bm, packets, out, r8, k8, P, S, rpairs, a_shared ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on ``stream``; returns the first CUDA error (0 = launched). Empty
// shapes launch nothing; K8 = 0 writes zeros.
extern "C" int mod2_matmul_launch(const void* bm, const void* packets,
                                  void* out, int r8, int k8, long long P,
                                  int S, void* stream) {
  if (r8 <= 0 || S <= 0 || P <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (k8 <= 0) {
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(S) * r8 * static_cast<size_t>(P), st));
  }
  // 8-byte stores and 4-byte loads need P % 8 == 0 and aligned pointers.
  const bool aligned = P % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(packets) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 8 == 0;
  auto b = static_cast<const uint8_t*>(bm);
  auto pk = static_cast<const uint8_t*>(packets);
  auto o = static_cast<uint8_t*>(out);
  if (r8 <= 16) {
    return aligned ? launch<1, true>(b, pk, o, r8, k8, P, S, st)
                   : launch<1, false>(b, pk, o, r8, k8, P, S, st);
  }
  return aligned ? launch<2, true>(b, pk, o, r8, k8, P, S, st)
                 : launch<2, false>(b, pk, o, r8, k8, P, S, st);
}
