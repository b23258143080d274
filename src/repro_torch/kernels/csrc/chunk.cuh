// Where the chunk coder puts things (DESIGN.md §6): the chunk codes and
// lengths, the 2-bit header's word and bit of a chunk, and the payload
// ranges a chunk writes.  Host and device code, so that
// tests/test_torch_pack_identities.py can build this header with g++ and
// check the placement for every code sequence of small rows.
//
// A row (one stream) of n_in words is nc = ceil(n_in / 512) chunks and a
// payload of cap = 512 * nc words.  Chunk c of code k holds len(k) = 0,
// 128, 256 or 512 words at row offset off(c) = len(0) + ... + len(c-1):
// its data range is [off, off + len).  The 512 - len slots it leaves empty
// are written as zeros at [cap - Z - (512 - len), cap - Z), Z = 512 c -
// off being the empty slots of the chunks before it, so that chunk 0's
// zeros end at cap and the last chunk's begin at the payload length: the
// zero ranges tile [payload_len, cap) and every chunk writes 512 words.
// Every offset is a multiple of 128 words.
#pragma once

#include <cstdint>

namespace lc {

constexpr int kChunk = 512;              // words per chunk (4 rows x 128)
constexpr int kLanes = 128;              // lanes of the packed tile
constexpr int kCodesPerWord = 16;        // 2-bit codes per header word

// The chunk's width code from its unsigned max word: stage zero gives 0
// or 3; stage narrow 0, 1 (< 2^8), 2 (< 2^16) or 3.
__host__ __device__ __forceinline__ uint32_t chunk_code(uint32_t mx,
                                                        bool narrow) {
  if (mx == 0u) return 0u;
  if (!narrow) return 3u;
  return mx < (1u << 8) ? 1u : (mx < (1u << 16) ? 2u : 3u);
}

// Payload words of a chunk of code k (codec._LC_LENS).
__host__ __device__ __forceinline__ uint32_t chunk_len(uint32_t code) {
  return code == 3u ? (uint32_t)kChunk : code * (uint32_t)(kChunk / 4);
}

// Words of a row's 2-bit header: pack_words(codes, 2) pads to whole
// tiles of 16 x 128 codes.
__host__ __device__ __forceinline__ long long header_words(long long nc) {
  const long long tile = (long long)kCodesPerWord * kLanes;
  return (nc + tile - 1) / tile * kLanes;
}

// The header word of chunk c in its row, and the shift of its 2 bits
// there: code c sits in field (c / 128) % 16 of word
// (c / 2048) * 128 + c % 128, as pack_words lays values out.
__host__ __device__ __forceinline__ long long header_word(long long c) {
  return c / ((long long)kCodesPerWord * kLanes) * kLanes + c % kLanes;
}

__host__ __device__ __forceinline__ int header_shift(long long c) {
  return 2 * (int)(c / kLanes % kCodesPerWord);
}

// First word of chunk c's zero range, given its offset and length.
__host__ __device__ __forceinline__ long long zero_start(long long cap,
                                                         long long c,
                                                         long long off,
                                                         uint32_t len) {
  return cap - ((long long)kChunk * c - off) - ((long long)kChunk - len);
}

}  // namespace lc
