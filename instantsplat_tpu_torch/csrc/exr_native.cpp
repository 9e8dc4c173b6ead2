// Scanline-EXR block decoder (host C++, loaded with ctypes by
// instantsplat_tpu_torch/data/exr.py; a copy of the JAX package's codec).
//
// The Python side parses the small header and hands the block region to
// this library, which does the hot part (per-block zlib inflate, the EXR
// byte-predictor reconstruction, and the row de-interleave into
// per-channel planes) in parallel over scanline blocks with a std::thread
// pool. data/exr.py keeps a pure-numpy decoder of the same logic, the
// plain version this one is tested against.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 exr_native.cpp -lz -lpthread
// (data/exr.py builds it on first use into build/instantsplat_tpu_torch/;
// the ABI below is plain C for ctypes.)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// EXR zip predictor inverse: un-delta (mod 256), then re-interleave the
// two halves (even output bytes come from the first half).
void predictor_decode(const uint8_t* in, size_t n, uint8_t* tmp,
                      uint8_t* out) {
  uint8_t prev = 0;
  for (size_t i = 0; i < n; ++i) {
    prev = static_cast<uint8_t>(prev + in[i] - 128u + (i == 0 ? 128u : 0u));
    tmp[i] = prev;
  }
  size_t half = (n + 1) / 2;
  const uint8_t* a = tmp;
  const uint8_t* b = tmp + half;
  size_t i = 0, j = 0;
  for (; j + 1 < n; j += 2, ++i) {
    out[j] = a[i];
    out[j + 1] = b[i];
  }
  if (j < n) out[j] = a[i];
}

struct BlockJob {
  int64_t off;  // file offset of the block payload (after y/size header)
  int32_t y;    // first scanline of the block
  int32_t size; // payload bytes
};

}  // namespace

extern "C" {

// Decode the scanline-block region of a single-part EXR.
//
//   buf, buf_len       whole file contents
//   first_block_off    offset of the first block's 8-byte (y, size) header
//   n_blocks           number of scanline blocks
//   lpb                lines per block (1 for NONE/ZIPS, 16 for ZIP)
//   compressed         nonzero when the file uses ZIP/ZIPS
//   width, height, y0  data window (y0 = dataWindow min.y)
//   n_channels         channels in file (alphabetical) order
//   pix_sz             [n_channels] bytes per pixel (2 half, 4 float/uint)
//   planes             [n_channels] row-major [height, width*pix_sz] outputs
//   n_threads          worker threads (<=0 -> hardware_concurrency)
//
// Returns 0 on success; 1 bad block framing; 2 zlib error; 3 short block.
int exr_decode_blocks(const uint8_t* buf, int64_t buf_len,
                      int64_t first_block_off, int32_t n_blocks, int32_t lpb,
                      int32_t compressed, int32_t width, int32_t height,
                      int32_t y0, int32_t n_channels, const int32_t* pix_sz,
                      uint8_t* const* planes, int32_t n_threads) {
  // Walk the sequential block headers once (variable-size blocks).
  std::vector<BlockJob> jobs(n_blocks);
  int64_t off = first_block_off;
  for (int i = 0; i < n_blocks; ++i) {
    if (off + 8 > buf_len) return 1;
    int32_t y, size;
    std::memcpy(&y, buf + off, 4);
    std::memcpy(&size, buf + off + 4, 4);
    off += 8;
    if (size < 0 || off + size > buf_len) return 1;
    jobs[i] = BlockJob{off, y, size};
    off += size;
  }

  size_t row_bytes = 0;
  for (int c = 0; c < n_channels; ++c)
    row_bytes += static_cast<size_t>(width) * pix_sz[c];
  const size_t max_raw = row_bytes * lpb;

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 4;
  if (n_threads > n_blocks) n_threads = n_blocks;
  if (n_threads < 1) n_threads = 1;

  std::atomic<int> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    std::vector<uint8_t> inflated(max_raw), tmp(max_raw), deint(max_raw);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_blocks || err.load()) return;
      const BlockJob& jb = jobs[i];
      // jb.y comes from untrusted file bytes: reject blocks whose scanline
      // range falls outside [y0, y0 + height) — a corrupt/malicious y below
      // y0 would otherwise index rows before the output planes.
      if (jb.y < y0 || jb.y - y0 >= height) { err.store(1); return; }
      int rows = height - (jb.y - y0);
      if (rows > lpb) rows = lpb;
      if (rows <= 0) { err.store(1); return; }
      const size_t want = row_bytes * rows;
      const uint8_t* raw = buf + jb.off;
      if (compressed && static_cast<size_t>(jb.size) < want) {
        // zlib payload (EXR stores the raw bytes when zlib doesn't win)
        uLongf dlen = static_cast<uLongf>(want);
        int rc = uncompress(inflated.data(), &dlen, raw,
                            static_cast<uLong>(jb.size));
        if (rc != Z_OK || dlen != want) { err.store(2); return; }
        predictor_decode(inflated.data(), want, tmp.data(), deint.data());
        raw = deint.data();
      } else if (static_cast<size_t>(jb.size) < want) {
        err.store(3);
        return;
      }
      // De-interleave rows into per-channel planes.
      size_t p = 0;
      for (int r = 0; r < rows; ++r) {
        int64_t row = jb.y - y0 + r;
        for (int c = 0; c < n_channels; ++c) {
          size_t nb = static_cast<size_t>(width) * pix_sz[c];
          std::memcpy(planes[c] + row * nb, raw + p, nb);
          p += nb;
        }
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

// Version tag so the Python side can verify the cached .so matches.
int exr_native_abi(void) { return 1; }

}  // extern "C"
