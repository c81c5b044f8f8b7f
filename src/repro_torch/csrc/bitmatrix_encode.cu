// GF(2) bitmatrix product on packed bit-planes (the crs backend) on Hopper.
//
//   out[s, i, :] = XOR of packets[s, j, :] over every j with bm[i, j] != 0
//
// bm (R8, K8) uint8 of 0/1, packets (S, K8, P) uint8 -> out (S, R8, P)
// uint8, all row-major and contiguous; one bitmatrix is shared by all S
// stripes. Packet j*8+i is bit-plane i of block j (kernels/ref.py
// packetize), so applying the GF(2) expansion of a GF(2^8) coefficient
// matrix to the packets is the GF(2^8) product of the blocks.
//
// Replaces the TPU kernels src/repro/kernels/bitmatrix_encode.py::
// bitmatrix_encode_batched (stripe grid) and ::bitmatrix_encode (flat;
// launched here with S = 1). The TPU kernel walks K8 with a masked XOR of
// (TR, TP) tiles in VMEM; here each thread walks K8 over its own 16 bytes.
//
// What bounds it on an H100: the product must move S*(K8+R8)*P bytes, which
// at 3.35 TB/s is the floor; the XORs are one 32-bit operation for every 4
// packed bytes of a selected row, far below the card's integer rate. In
// this first version the kernel reads each packet row once per output
// block of 8 rows, so an R8 of 32 reads the packets four times (from L2
// when it holds them).
//
// What the design does about it:
// * each thread owns 16 packed bytes (uint4 loads and stores, neighbouring
//   threads on neighbouring addresses) of one stripe and one output block
//   of 8 rows, whose XOR sums stay in 8 register accumulators across the
//   whole K8 loop;
// * the block builds, in shared memory, one byte per input row j holding
//   the 8 output rows' bits bm[r, j]; the byte is the same for every thread
//   of the block, so the select is a warp-uniform branch, and a row that no
//   output row selects is never loaded;
// * a ragged P tail (P not a multiple of 16, or unaligned pointers) takes a
//   byte-wise path in the same kernel: no padding, no extra copies.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kVec = 16;        // packed bytes of each row that one thread owns
constexpr int kRows = 8;        // output rows per block tile (one register each)
constexpr int kChunkK = 2048;   // input rows whose row masks sit in shared
                                // memory at a time

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x; acc.y ^= v.y; acc.z ^= v.z; acc.w ^= v.w;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
bitmatrix_encode_kernel(const uint8_t* __restrict__ bm,
                        const uint8_t* __restrict__ packets,
                        uint8_t* __restrict__ out,
                        int r8, int k8, long long P, int S, int rtiles) {
  __shared__ uint8_t s_mask[kChunkK];

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  const bool active = col < P;
  const int tiles = S * rtiles;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int s = t / rtiles;
    const int r0 = (t - s * rtiles) * kRows;
    const int tr = min(kRows, r8 - r0);
    const uint8_t* src = packets + static_cast<long long>(s) * k8 * P + col;

    uint4 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_uint4(0u, 0u, 0u, 0u);

    for (int j0 = 0; j0 < k8; j0 += kChunkK) {
      const int kc = min(kChunkK, k8 - j0);
      __syncthreads();  // the previous chunk's masks are done with
      for (int j = threadIdx.x; j < kc; j += kThreads) {
        unsigned m = 0u;
        for (int r = 0; r < tr; ++r) {
          m |= (bm[static_cast<long long>(r0 + r) * k8 + j0 + j] != 0) << r;
        }
        s_mask[j] = static_cast<uint8_t>(m);
      }
      __syncthreads();
      if (!active) continue;

      for (int j = 0; j < kc; ++j) {
        const unsigned m = s_mask[j];
        if (m == 0u) continue;  // warp-uniform: no output row selects row j
        const uint8_t* row = src + static_cast<long long>(j0 + j) * P;
        uint4 v;
        if (kAligned) {
          v = *reinterpret_cast<const uint4*>(row);
        } else {
          uint32_t w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t word = 0u;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              if (col + q * 4 + b < P) {
                word |= static_cast<uint32_t>(row[q * 4 + b]) << (8 * b);
              }
            }
            w[q] = word;
          }
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (m & (1u << r)) xor_into(acc[r], v);
        }
      }
    }

    if (!active) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= tr) break;
      uint8_t* dst = out + (static_cast<long long>(s) * r8 + r0 + r) * P + col;
      if (kAligned) {
        *reinterpret_cast<uint4*>(dst) = acc[r];
      } else {
        const uint32_t w[4] = {acc[r].x, acc[r].y, acc[r].z, acc[r].w};
#pragma unroll
        for (int b = 0; b < kVec; ++b) {
          if (col + b < P) {
            dst[b] = static_cast<uint8_t>(w[b >> 2] >> (8 * (b & 3)));
          }
        }
      }
    }
  }
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched). Empty
// shapes launch nothing; K8 = 0 writes zeros.
extern "C" int bitmatrix_encode_launch(const void* bm, const void* packets,
                                       void* out, int r8, int k8,
                                       long long P, int S, void* stream) {
  if (r8 <= 0 || S <= 0 || P <= 0) return 0;
  const int rtiles = (r8 + kRows - 1) / kRows;
  const bool aligned = P % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(packets) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per_block = static_cast<long long>(kThreads) * kVec;
  const long long tiles = static_cast<long long>(S) * rtiles;
  dim3 grid(static_cast<unsigned>((P + per_block - 1) / per_block),
            static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint8_t*>(bm);
  auto pk = static_cast<const uint8_t*>(packets);
  auto o = static_cast<uint8_t*>(out);
  if (aligned) {
    bitmatrix_encode_kernel<true><<<grid, kThreads, 0, st>>>(
        b, pk, o, r8, k8, P, S, rtiles);
  } else {
    bitmatrix_encode_kernel<false><<<grid, kThreads, 0, st>>>(
        b, pk, o, r8, k8, P, S, rtiles);
  }
  return static_cast<int>(cudaGetLastError());
}
