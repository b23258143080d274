// The chunk coder's placement (src/repro_torch/kernels/csrc/chunk.cuh), as
// the select and expand kernels of csrc/lossless.cu use it, for one row on
// the host: built by g++ against cuda_runtime.h (this directory's
// stand-in) in tests/test_torch_chunk_place.py, which holds it against
// the reference's compaction, gather and 2-bit header pack.
#include "cuda_runtime.h"
#include "chunk.cuh"

extern "C" {

// One row of nc chunks: image [nc * 512] (each chunk narrowed and
// left-aligned, as B5 writes it) and codes [nc].  Writes payload
// [512 * nc] as the select kernel places it (data at [off, off + len),
// zeros at zero_start), adds one to writes[i] for each word written,
// ORs the codes into header [header_words(nc)] (zeroed by the caller) and
// returns the payload length.
long long place_row(const uint32_t* image, const int32_t* codes,
                    long long nc, uint32_t* payload, int32_t* writes,
                    uint32_t* header) {
  const long long cap = nc * lc::kChunk;
  long long off = 0;
  for (long long c = 0; c < nc; ++c) {
    const uint32_t code = (uint32_t)codes[c] & 3u;
    const uint32_t len = lc::chunk_len(code);
    const long long zs = lc::zero_start(cap, c, off, len);
    for (uint32_t slot = 0; slot < (uint32_t)lc::kChunk; ++slot) {
      const long long at = slot < len ? off + slot : zs + (slot - len);
      if (at < 0 || at >= cap) return -1 - c;
      payload[at] = slot < len ? image[c * lc::kChunk + slot] : 0u;
      writes[at] += 1;
    }
    if (code != 0u) header[lc::header_word(c)] |= code << lc::header_shift(c);
    off += len;
  }
  return off;
}

// The inverse as the expand kernel reads it: each chunk's code from the
// header, its words from [off, off + len) of payload [width], a source
// index clipped to width - 1.  Writes out [nc * 512], each chunk narrowed
// and left-aligned, zero past its length (the reference's gather).
void gather_row(const uint32_t* header, const uint32_t* payload,
                long long width, long long nc, uint32_t* out) {
  long long off = 0;
  for (long long c = 0; c < nc; ++c) {
    const uint32_t code =
        (header[lc::header_word(c)] >> lc::header_shift(c)) & 3u;
    const uint32_t len = lc::chunk_len(code);
    for (uint32_t slot = 0; slot < (uint32_t)lc::kChunk; ++slot) {
      const long long s = off + slot < width - 1 ? off + slot : width - 1;
      out[c * lc::kChunk + slot] = slot < len ? payload[s] : 0u;
    }
    off += len;
  }
}

uint32_t code_of(uint32_t mx, int narrow) {
  return lc::chunk_code(mx, narrow != 0);
}

long long header_words_of(long long nc) { return lc::header_words(nc); }

}  // extern "C"
