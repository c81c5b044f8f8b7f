// GF(2) bitmatrix product as a mod-2 integer matmul on the tensor cores
// (the mxu backend) on Hopper.
//
//   out[s] = repack( (bm (R8, K8) @ bits(packets[s]) (K8, 8P)) & 1 )
//
// bm (R8, K8) uint8 of 0/1, packets (S, K8, P) uint8 -> out (S, R8, P)
// uint8, all row-major and contiguous. bits() unpacks packed byte p of a
// row into columns 8p..8p+7 (bit t to column 8p+t) and repack() is its
// inverse, so this is the same function as bitmatrix_encode.cu: an XOR sum
// over GF(2) is an ordinary sum taken mod 2.
//
// Replaces the TPU kernels src/repro/kernels/bitmatrix_encode.py::
// mod2_matmul_encode_batched (stripe grid) and ::mod2_matmul_encode (flat;
// launched here with S = 1), which run the product on the MXU in bf16 with
// a float32 accumulator. Here the operands are int8 0/1 and the
// accumulators int32 (nvcuda::wmma m16n16k16), exact for any K8 < 2^31.
//
// What bounds it on an H100: the product must move S*(K8+R8)*P bytes
// (3.35 TB/s); the tensor-core work, 2*S*R8'*K8'*8P int8 operations at
// 1,979 TOPS (R8', K8' padded to the tile), is below that for the
// repair and seal shapes. In this first version the unpack of each packed
// byte into 8 bytes of shared memory is likely what bounds it.
//
// What the design does about it:
// * a block owns 32 packed bytes (256 bit columns) of one stripe and BM
//   output rows (16, 32 or 64: the smallest tile that covers R8; a wider R8
//   walks several row groups), and walks K8 in stages of 64 rows;
// * each stage loads the packets once (8 bytes a thread) and unpacks them
//   with two multiplies into 0/1 bytes in shared memory, laid out tile by
//   tile so every wmma fragment starts on a 256-byte boundary; R8 and K8
//   that are not multiples of 16 are zero-padded there, never in the
//   output, and k steps wholly past K8 are skipped;
// * each of the 8 warps keeps the int32 sums of its 2 column tiles of all
//   BM rows in registers across the K8 loop, then takes & 1 and packs 8
//   columns a byte through a 1 KB shared scratch of its own;
// * the block writes its (BM, 32)-byte output tile with 16-byte stores; a
//   ragged P tail (P not a multiple of 16, or unaligned pointers) takes a
//   byte-wise path in the same kernel.
#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileP = 32;               // packed bytes a block owns
constexpr int kNT = kTileP * 8 / 16;     // 16 column tiles of 16 bits
constexpr int kNPerWarp = kNT / kWarps;  // 2 column tiles a warp
constexpr int kChunkK = 64;              // packet rows per shared-memory stage
constexpr int kKT = kChunkK / 16;        // 4 k steps a stage

// Spread the low 4 bits of ``nib`` to the low bit of 4 bytes: the four
// shifted copies (0, 7, 14, 21) occupy disjoint bits, so nothing carries.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

template <int BM, bool kAligned>
__global__ void __launch_bounds__(kThreads)
mod2_matmul_kernel(const uint8_t* __restrict__ bm,
                   const uint8_t* __restrict__ packets,
                   uint8_t* __restrict__ out,
                   int r8, int k8, long long P, int S, int rgroups) {
  constexpr int MT = BM / 16;
  // [k step][row][16]: fragment (mi, kk) at (kk * BM + 16 mi) * 16.
  __shared__ __align__(256) signed char s_a[kKT * BM * 16];
  // [k step][column tile][16][16]: fragment (kk, ni) at (kk * kNT + ni) * 256.
  __shared__ __align__(256) signed char s_b[kKT * kNT * 256];
  __shared__ __align__(256) int s_acc[kWarps][256];
  __shared__ __align__(16) uint8_t s_out[BM * kTileP];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTileP;
  const int tiles = S * rgroups;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int s = t / rgroups;
    const int r0 = (t - s * rgroups) * BM;
    const uint8_t* src = packets + static_cast<long long>(s) * k8 * P;

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[MT][kNPerWarp];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int ni = 0; ni < kNPerWarp; ++ni) wmma::fill_fragment(acc[mi][ni], 0);
    }

    for (int j0 = 0; j0 < k8; j0 += kChunkK) {
      __syncthreads();  // the previous stage (and tile) is done with s_a/s_b
      for (int e = threadIdx.x; e < BM * kChunkK; e += kThreads) {
        const int r = e / kChunkK;
        const int k = e - r * kChunkK;
        const int gr = r0 + r;
        const int gk = j0 + k;
        s_a[((k >> 4) * BM + r) * 16 + (k & 15)] =
            (gr < r8 && gk < k8 &&
             bm[static_cast<long long>(gr) * k8 + gk] != 0) ? 1 : 0;
      }
      {
        // 64 rows x 32 packed bytes: 8 bytes a thread.
        const int k = threadIdx.x >> 2;
        const int q = threadIdx.x & 3;
        const int gk = j0 + k;
        const long long gp = p0 + 8 * q;
        uint32_t w[2] = {0u, 0u};
        if (gk < k8) {
          const uint8_t* row = src + static_cast<long long>(gk) * P + gp;
          if (kAligned) {
            if (gp < P) {
              const uint2 v = *reinterpret_cast<const uint2*>(row);
              w[0] = v.x;
              w[1] = v.y;
            }
          } else {
#pragma unroll
            for (int b = 0; b < 8; ++b) {
              if (gp + b < P) {
                w[b >> 2] |= static_cast<uint32_t>(row[b]) << (8 * (b & 3));
              }
            }
          }
        }
        signed char* dst = s_b + ((k >> 4) * kNT * 16 + (k & 15)) * 16;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t byte = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
          const int pl = 8 * q + i;  // packed byte within the block's 32
          *reinterpret_cast<uint2*>(dst + (pl >> 1) * 256 + 8 * (pl & 1)) =
              make_uint2(spread4(byte & 15u), spread4(byte >> 4));
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        if (j0 + kk * 16 >= k8) break;  // block-uniform: only zero padding left
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>
            b[kNPerWarp];
#pragma unroll
        for (int ni = 0; ni < kNPerWarp; ++ni) {
          wmma::load_matrix_sync(
              b[ni], s_b + (kk * kNT + warp * kNPerWarp + ni) * 256, 16);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> a;
          wmma::load_matrix_sync(a, s_a + (kk * BM + mi * 16) * 16, 16);
#pragma unroll
          for (int ni = 0; ni < kNPerWarp; ++ni) {
            wmma::mma_sync(acc[mi][ni], a, b[ni], acc[mi][ni]);
          }
        }
      }
    }

    // & 1 and repack: lane l packs row l/2, columns 8(l%2)..+7 of a tile.
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int ni = 0; ni < kNPerWarp; ++ni) {
        wmma::store_matrix_sync(s_acc[warp], acc[mi][ni], 16,
                                wmma::mem_row_major);
        __syncwarp();
        const int row = lane >> 1;
        const int half = lane & 1;
        uint32_t byte = 0u;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          byte |= static_cast<uint32_t>(s_acc[warp][row * 16 + 8 * half + c] & 1)
                  << c;
        }
        s_out[(mi * 16 + row) * kTileP + (warp * kNPerWarp + ni) * 2 + half] =
            static_cast<uint8_t>(byte);
        __syncwarp();
      }
    }
    __syncthreads();
    {
      const int row = threadIdx.x >> 1;
      const int half = threadIdx.x & 1;
      const long long gp = p0 + 16 * half;
      if (row < BM && r0 + row < r8 && gp < P) {
        uint8_t* dst =
            out + (static_cast<long long>(s) * r8 + r0 + row) * P + gp;
        const uint8_t* from = s_out + row * kTileP + 16 * half;
        if (kAligned) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(from);
        } else {
          for (int b = 0; b < 16 && gp + b < P; ++b) dst[b] = from[b];
        }
      }
    }
    __syncthreads();  // s_out is read out before the next tile writes it
  }
}

template <int BM>
void launch_rows(bool aligned, dim3 grid, cudaStream_t stream,
                 const uint8_t* bm, const uint8_t* packets, uint8_t* out,
                 int r8, int k8, long long P, int S, int rgroups) {
  if (aligned) {
    mod2_matmul_kernel<BM, true><<<grid, kThreads, 0, stream>>>(
        bm, packets, out, r8, k8, P, S, rgroups);
  } else {
    mod2_matmul_kernel<BM, false><<<grid, kThreads, 0, stream>>>(
        bm, packets, out, r8, k8, P, S, rgroups);
  }
}

// Rows of the block tile for ``r8`` output rows (kernels/bitmatrix_encode.py
// ``mod2_padded_shape`` mirrors this to count the padded work).
int row_tile(int r8) { return r8 <= 16 ? 16 : r8 <= 32 ? 32 : 64; }

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched). Empty
// shapes launch nothing; K8 = 0 writes zeros.
extern "C" int mod2_matmul_launch(const void* bm, const void* packets,
                                  void* out, int r8, int k8, long long P,
                                  int S, void* stream) {
  if (r8 <= 0 || S <= 0 || P <= 0) return 0;
  const int rows = row_tile(r8);
  const int rgroups = (r8 + rows - 1) / rows;
  // 16-byte output stores need P % 16 == 0; the 8-byte packet loads follow.
  const bool aligned = P % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(packets) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long tiles = static_cast<long long>(S) * rgroups;
  dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP),
            static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint8_t*>(bm);
  auto pk = static_cast<const uint8_t*>(packets);
  auto o = static_cast<uint8_t*>(out);
  switch (rows) {
    case 16: launch_rows<16>(aligned, grid, st, b, pk, o, r8, k8, P, S, rgroups); break;
    case 32: launch_rows<32>(aligned, grid, st, b, pk, o, r8, k8, P, S, rgroups); break;
    default: launch_rows<64>(aligned, grid, st, b, pk, o, r8, k8, P, S, rgroups); break;
  }
  return static_cast<int>(cudaGetLastError());
}
