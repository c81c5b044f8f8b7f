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
// bitmatrix_encode_batched (stripe grid, pallas_call at :115) and
// ::bitmatrix_encode (flat, pallas_call at :60; launched here with S = 1).
// The TPU kernel walks K8 with a masked XOR of (TR, TP) tiles in VMEM.
//
// What bounds it on an H100: bytes. The product must move S*(K8+R8)*P
// bytes, which at 3.35 TB/s (the published rate of an H100 SXM at its
// 700 W limit) is the floor. Reaching it takes each packet byte read once,
// enough loads in flight on every SM, and that at S = 1 too (the seal
// encodes one stripe of P = 131072 at a time). Behind the
// bytes comes the SM's 32-bit integer pipe: a branch-free select costs one
// LOP3 per output row and 4 packed bytes, selected or not.
//
// What the design does about it:
// * one pass over the packets: a warp owns one work item, a stripe, a
//   column chunk (32 lanes of 16 or 8 packed bytes) and a group of up to
//   G = 8, 16 or 32 output rows, all of whose XOR sums stay in registers
//   while it walks K8. The main path has R8 = 8, 16 (repairs, degraded
//   reads) or 32 (seal), so it reads every packet byte once; a larger R8
//   walks groups of 32 (blockIdx.y) and reads the packets again from L2;
// * the masks once per block and row group, in shared memory: for each
//   input row j one 32-bit word whose bit r is bm[r0 + r, j] != 0, read
//   from bm row by row (coalesced), and a compact list of the j whose word
//   is not zero (warp ballots and a block prefix), so the loop over K8 has
//   no data-dependent branch and never loads a row that no output selects;
// * G <= 16 (W = 4 words, uint4 loads and stores): a branch-free select,
//   acc[r] ^= v & M, with M = 0 or all ones from bit r of the row's word
//   (one PRMT per row and one LOP3 per word), over two register buffers of
//   U = 4 rows, so the next rows' loads are in flight during the XORs;
// * G = 32 (W = 2, uint2): 64 accumulators leave no registers for that,
//   and 32 selects per row would hold the integer pipe. The rows go in
//   quads instead: each lane stores the quad's 15 XOR combinations in
//   shared memory, and each output row XORs in the one its 4-bit pattern
//   names (patterns built with the compact list): 11 XORs a word for the
//   table plus one per row, against 4 selects per row;
// * where the stripes and column chunks give too few warps to fill the
//   card (S = 1 above all), the block's 8 warps split the compact list
//   into ks = 2, 4 or 8 contiguous slices (whole quads) for the same
//   columns and reduce their partial sums by XOR through shared memory at
//   the end, 16 words a lane per round;
// * launch bounds keep every 16-byte instantiation within the 128
//   registers that let 2 blocks share a SM; no instantiation spills;
// * edges in the same kernel: a ragged P or packets/out off a 16-byte
//   boundary take a byte-wise instantiation (one row at a time, the
//   select path for every G); K8 = 0 writes zeros; rows of a group past R8
//   have zero masks and are not stored; K8 past 2048 rows rebuilds the
//   compact list for each chunk of 2048; slices past the end of a short
//   list stay empty and add zero to the reduction.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kWarps = kThreads / 32;  // warps per block
constexpr int kChunkK = 2048;          // input rows in the compact list at once
constexpr int kRedWords = 16;          // words a lane hands over per round

template <int G>
struct Tile {
  static constexpr int W = G <= 16 ? 4 : 2;        // 32-bit words a lane owns
  static constexpr int U = 4;                      // rows in a load buffer
  static constexpr int kBytes = 4 * W;             // packed bytes a lane owns
  static constexpr int kSpan = 32 * kBytes;        // packed bytes a warp owns
  static constexpr int kRounds = G * W / kRedWords;  // reduction rounds
  // Warps that fill the card: G = 32 stops at one wave of blocks (the
  // seal's 512 work items split 4 ways), G <= 16 at about two.
  static constexpr long long kTargetWarps = G <= 16 ? 4096 : 2048;
};

// G = 32 on the 16-byte path XORs through a table of each quad of listed
// rows (see accumulate_quads); its compact list holds quad patterns.
template <int G, bool kAligned>
constexpr bool kQuads = kAligned && G == 32;

struct Shared {
  alignas(16) uint32_t mask[kChunkK];     // word (or quad pattern) of each
  uint16_t j[kChunkK];                    // listed input row (in the chunk)
  int warp_count[kWarps];
  union {                                 // quad tables while the warps walk
    uint2 table[kWarps][16][32];          // K8, partial sums after
    uint32_t red[kWarps][kRedWords][32];
  };
};

// Builds the compact list of input rows j0 .. j0+kc-1 for output rows
// r0 .. r0+rows-1 and returns its length. Every thread of the block calls
// it; it starts and ends with a barrier. With kQuad, each aligned quad of
// list words m0..m3 is rewritten as four pattern words: nibble r % 8 of
// word r / 8 holds bit r of m0..m3 (bit u from m_u), the index into the
// quad's table of row r; the words past the list's end count as zero.
template <int G, bool kQuad>
__device__ int build_list(Shared& sh, const uint8_t* __restrict__ bm, int k8,
                          int r0, int rows, int j0, int kc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int base = 0;
  __syncthreads();  // nobody still reads the previous list
  for (int p = 0; p < kc; p += kThreads) {
    const int j = p + threadIdx.x;
    uint32_t word = 0u;
    if (j < kc) {
      const uint8_t* col = bm + static_cast<long long>(r0) * k8 + j0 + j;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r < rows) {
          word |= static_cast<uint32_t>(col[static_cast<long long>(r) * k8]
                                        != 0) << r;
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, word != 0u);
    if (lane == 0) sh.warp_count[warp] = __popc(ballot);
    __syncthreads();
    int off = base;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = sh.warp_count[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (word != 0u) {
      off += __popc(ballot & ((1u << lane) - 1u));
      sh.mask[off] = word;
      sh.j[off] = static_cast<uint16_t>(j);
    }
    base += total;
    __syncthreads();  // warp_count is rewritten by the next pass
  }
  if constexpr (kQuad) {
    for (int q = threadIdx.x; 4 * q < base; q += kThreads) {
      uint32_t m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        m[u] = 4 * q + u < base ? sh.mask[4 * q + u] : 0u;
      }
      uint32_t pat[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int r = 0; r < 32; ++r) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pat[r >> 3] |= ((m[u] >> r) & 1u) << (4 * (r & 7) + u);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) sh.mask[4 * q + u] = pat[u];
    }
  }
  __syncthreads();
  return base;
}

template <int W, bool kAligned>
__device__ __forceinline__ void load_row(uint32_t (&v)[W],
                                         const uint8_t* row, long long room,
                                         bool ok) {
  if constexpr (kAligned && W == 4) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (ok) x = *reinterpret_cast<const uint4*>(row);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (kAligned) {
    uint2 x = make_uint2(0u, 0u);
    if (ok) x = *reinterpret_cast<const uint2*>(row);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) {
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

template <int W, bool kAligned>
__device__ __forceinline__ void store_row(uint8_t* dst, const uint32_t (&v)[W],
                                          long long room) {
  if constexpr (kAligned && W == 4) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kAligned) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int b = 0; b < 4 * W; ++b) {
      if (b < room) dst[b] = static_cast<uint8_t>(v[b >> 2] >> (8 * (b & 3)));
    }
  }
}

// All ones if bit r of m is set, else zero: one PRMT that replicates the
// sign of byte r / 8 of m << (7 - r % 8), whose top bit is bit r of m (the
// shift is shared by the rows with the same r % 8).
__device__ __forceinline__ uint32_t row_select(uint32_t m, int r) {
  uint32_t sel;
  asm("prmt.b32 %0, %1, 0, %2;"
      : "=r"(sel)
      : "r"(m << (7 - (r & 7))), "r"(0x8888u | (0x1111u * (r >> 3))));
  return sel;
}

// Loads listed rows i .. i+U-1 (those below hi; the rest load nothing and
// are zero) and, into m, their words (zero past hi, so they select
// nothing).
template <int U, int W, bool kAligned>
__device__ __forceinline__ void load_rows(uint32_t (&v)[U][W],
                                          const Shared& sh,
                                          const uint8_t* __restrict__ src,
                                          long long P, long long room, int i,
                                          int hi) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool ok = i + u < hi;
    const int j = ok ? sh.j[i + u] : 0;
    load_row<W, kAligned>(v[u], src + static_cast<long long>(j) * P, room,
                          ok);
  }
}

template <int U, int W, bool kAligned>
__device__ __forceinline__ void fetch(uint32_t (&v)[U][W], uint32_t (&m)[U],
                                      const Shared& sh,
                                      const uint8_t* __restrict__ src,
                                      long long P, long long room, int i,
                                      int hi) {
  load_rows<U, W, kAligned>(v, sh, src, P, room, i, hi);
#pragma unroll
  for (int u = 0; u < U; ++u) m[u] = i + u < hi ? sh.mask[i + u] : 0u;
}

template <int G, int U, int W>
__device__ __forceinline__ void select_xor(uint32_t (&acc)[G][W],
                                           const uint32_t (&v)[U][W],
                                           const uint32_t (&m)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const uint32_t sel = row_select(m[u], r);
#pragma unroll
      for (int w = 0; w < W; ++w) acc[r][w] ^= v[u][w] & sel;
    }
  }
}

// acc[r] ^= the XOR of quad rows v[u] whose bit u is set in row r's
// pattern: the lane stores the quad's 15 non-zero XOR combinations in its
// column of the warp's table (row p of the table is combination p, row 0
// stays zero), then each output row XORs in one table row. That is 11
// XORs a word to build the table and one a row, against four selects a
// row; the reads go through shared memory, which has the bandwidth to
// spare. Each lane reads only what it wrote, so no barrier is needed.
template <int G>
__device__ __forceinline__ void quad_xor(uint32_t (&acc)[G][2],
                                         const uint32_t (&v)[4][2],
                                         uint2 (&table)[16][32],
                                         const uint32_t* pat, int lane) {
#pragma unroll
  for (int p = 1; p < 16; ++p) {
    uint32_t c[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      c[w] = 0u;
#pragma unroll
      for (int u = 0; u < 4; ++u) c[w] ^= (p >> u) & 1 ? v[u][w] : 0u;
    }
    table[p][lane] = make_uint2(c[0], c[1]);
  }
  const uint4 pw = *reinterpret_cast<const uint4*>(pat);
  const char* column = reinterpret_cast<const char*>(&table[0][lane]);
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const uint32_t word = r < 8 ? pw.x : r < 16 ? pw.y : r < 24 ? pw.z : pw.w;
    // byte offset of table row (nibble r % 8) = nibble * 256
    const int shift = 4 * (r & 7) - 8;
    const uint32_t off =
        (shift < 0 ? word << -shift : word >> shift) & 0xF00u;
    const uint2 x = *reinterpret_cast<const uint2*>(column + off);
    acc[r][0] ^= x.x;
    acc[r][1] ^= x.y;
  }
}

// accumulate for G = 32 on the 16-byte path: the list in quads (lo is a
// multiple of 4), each quad's four rows loaded together and XORed through
// its table. One buffer: a second one (the next quad's loads in flight
// during the XORs) spills at 128 registers, and was no faster at S = 1.
template <int G>
__device__ __forceinline__ void accumulate_quads(
    uint32_t (&acc)[G][2], Shared& sh, const uint8_t* __restrict__ src,
    long long P, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  uint2 (&table)[16][32] = sh.table[threadIdx.x >> 5];
  table[0][lane] = make_uint2(0u, 0u);
  for (int i = lo; i < hi; i += 4) {
    uint32_t v[4][2];
    load_rows<4, 2, true>(v, sh, src, P, 0, i, hi);
    quad_xor<G>(acc, v, table, sh.mask + i, lane);
  }
}

// acc[r] ^= packets row j for every listed j in [lo, hi) whose word has
// bit r. Two register buffers of U rows: the next U rows' loads are in
// flight while the current ones are XORed. The byte-wise path loads one
// row at a time (each of its bytes takes a register).
template <int G, bool kAligned>
__device__ __forceinline__ void accumulate(
    uint32_t (&acc)[G][Tile<G>::W], const Shared& sh,
    const uint8_t* __restrict__ src, long long P, long long room, int lo,
    int hi) {
  constexpr int W = Tile<G>::W;
  constexpr int U = kAligned ? Tile<G>::U : 1;
  uint32_t va[U][W], vb[U][W], ma[U], mb[U];
  fetch<U, W, kAligned>(va, ma, sh, src, P, room, lo, hi);
  for (int i = lo; i < hi; i += 2 * U) {
    fetch<U, W, kAligned>(vb, mb, sh, src, P, room, i + U, hi);
    select_xor<G, U, W>(acc, va, ma);
    if (i + U >= hi) break;
    fetch<U, W, kAligned>(va, ma, sh, src, P, room, i + 2 * U, hi);
    select_xor<G, U, W>(acc, vb, mb);
  }
}

// One block: the work items ipb = 8 / ks of block column blockIdx.x, each
// by ks warps, for every row group g = blockIdx.y, blockIdx.y + gridDim.y..
template <int G, bool kAligned>
__global__ void __launch_bounds__(kThreads, kAligned ? 2 : 1)
bitmatrix_encode_kernel(const uint8_t* __restrict__ bm,
                        const uint8_t* __restrict__ packets,
                        uint8_t* __restrict__ out, int r8, int k8,
                        long long P, int S, long long chunks, int ks) {
  using T = Tile<G>;
  constexpr int W = T::W;
  constexpr int RR = kRedWords / W;  // output rows per reduction round
  __shared__ Shared sh;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ipb = kWarps / ks;
  const int slice = warp % ks;
  const long long item0 = static_cast<long long>(blockIdx.x) * ipb;
  const long long items = static_cast<long long>(S) * chunks;
  const long long item = item0 + warp / ks;
  const long long s = item < items ? item / chunks : 0;
  const long long col = (item - s * chunks) * T::kSpan +
                        static_cast<long long>(lane) * T::kBytes;
  const bool active = item < items && col < P;
  const uint8_t* src = packets + s * k8 * P + col;

  const int groups = (r8 - 1) / G + 1;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const int r0 = g * G;
    const int rows = min(G, r8 - r0);
    uint32_t acc[G][W];
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int w = 0; w < W; ++w) acc[r][w] = 0u;
    }
    for (int j0 = 0; j0 == 0 || j0 < k8; j0 += kChunkK) {
      const int n = build_list<G, kQuads<G, kAligned>>(
          sh, bm, k8, r0, rows, j0, min(kChunkK, k8 - j0));
      const int per = ((n + ks - 1) / ks + 3) & ~3;  // whole quads a slice
      const int lo = min(n, slice * per);
      const int hi = min(n, lo + per);
      if (active) {
        if constexpr (kQuads<G, kAligned>) {
          accumulate_quads<G>(acc, sh, src + static_cast<long long>(j0) * P,
                              P, lo, hi);
        } else {
          accumulate<G, kAligned>(acc, sh,
                                  src + static_cast<long long>(j0) * P, P,
                                  P - col, lo, hi);
        }
      }
    }

    if (ks == 1) {  // the warp holds the whole sum
      if (!active) continue;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r >= rows) break;
        store_row<W, kAligned>(out + (s * r8 + r0 + r) * P + col, acc[r],
                               P - col);
      }
      continue;
    }
    // ks slices of each item: XOR their partial sums through shared
    // memory, RR rows a round, one lane's W words per thread.
#pragma unroll
    for (int round = 0; round < T::kRounds; ++round) {
      __syncthreads();  // the previous round's readers are done
#pragma unroll
      for (int q = 0; q < RR; ++q) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          sh.red[warp][q * W + w][lane] = acc[round * RR + q][w];
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < ipb * RR * 32; e += kThreads) {
        const int l = e & 31;
        const int q = (e >> 5) % RR;
        const int it = (e >> 5) / RR;
        const int r = round * RR + q;
        const long long o_item = item0 + it;
        if (o_item >= items || r >= rows) continue;
        const long long os = o_item / chunks;
        const long long ocol = (o_item - os * chunks) * T::kSpan +
                               static_cast<long long>(l) * T::kBytes;
        if (ocol >= P) continue;
        uint32_t x[W];
#pragma unroll
        for (int w = 0; w < W; ++w) x[w] = 0u;
        for (int sl = 0; sl < ks; ++sl) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            x[w] ^= sh.red[it * ks + sl][q * W + w][l];
          }
        }
        store_row<W, kAligned>(out + (os * r8 + r0 + r) * P + ocol, x,
                               P - ocol);
      }
    }
  }
}

template <int G>
int launch(const uint8_t* bm, const uint8_t* packets, uint8_t* out, int r8,
           int k8, long long P, int S, bool aligned, cudaStream_t stream) {
  using T = Tile<G>;
  const long long chunks = (P + T::kSpan - 1) / T::kSpan;
  const long long items = static_cast<long long>(S) * chunks;
  const long long groups = (r8 - 1) / G + 1;
  // Split K8 over more warps until the card has enough of them, while
  // every slice keeps at least 8 input rows.
  int ks = 1;
  while (ks < kWarps && items * groups * ks < T::kTargetWarps &&
         k8 >= 16 * ks) {
    ks *= 2;
  }
  const long long cols = (items + kWarps / ks - 1) / (kWarps / ks);
  if (cols > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(cols),
            static_cast<unsigned>(groups < 65535 ? groups : 65535));
  if (aligned) {
    bitmatrix_encode_kernel<G, true><<<grid, kThreads, 0, stream>>>(
        bm, packets, out, r8, k8, P, S, chunks, ks);
  } else {
    bitmatrix_encode_kernel<G, false><<<grid, kThreads, 0, stream>>>(
        bm, packets, out, r8, k8, P, S, chunks, ks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched). Empty
// shapes launch nothing; K8 = 0 writes zeros.
extern "C" int bitmatrix_encode_launch(const void* bm, const void* packets,
                                       void* out, int r8, int k8,
                                       long long P, int S, void* stream) {
  if (r8 <= 0 || S <= 0 || P <= 0) return 0;
  const bool aligned = P % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(packets) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint8_t*>(bm);
  auto pk = static_cast<const uint8_t*>(packets);
  auto o = static_cast<uint8_t*>(out);
  if (r8 <= 8) return launch<8>(b, pk, o, r8, k8, P, S, aligned, st);
  if (r8 <= 16) return launch<16>(b, pk, o, r8, k8, P, S, aligned, st);
  return launch<32>(b, pk, o, r8, k8, P, S, aligned, st);
}
