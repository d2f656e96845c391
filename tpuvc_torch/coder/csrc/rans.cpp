// Host-side rANS entropy coder (the port's own copy of tpuvc's
// coder/csrc/rans.cpp; same stream format, so tpuvc and tpuvc_torch streams
// are read the same way).
//
// Interleaved encoding of quantized symbols against 16-bit quantized CDF
// tables, with an escape + bypass path for out-of-range symbols. Device code
// produces symbols and CDF table indexes; this library turns them into bytes
// and back.
//
// Stream format:
//   [4-byte little-endian final rANS state][renormalization bytes, reversed]
// Symbols are encoded last-to-first so the decoder reads first-to-last.
// Escape: symbol slot cdf_length-2 codes "out of range", followed by a
// zigzagged magnitude in 8-bit chunks (7 payload bits + 1 continuation bit).
//
// rANS parameters: 16-bit probability precision, 32-bit state,
// byte-wise renormalization, L = 1 << 23.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kPrecision = 16;
constexpr uint32_t kLowerBound = 1u << 23;
constexpr uint32_t kProbMask = (1u << kPrecision) - 1;

struct Encoder {
  uint32_t state = kLowerBound;
  std::vector<uint8_t> bytes;  // renorm bytes in emission order

  inline void put(uint32_t start, uint32_t freq) {
    // Renormalize, then push the symbol.
    const uint32_t x_max = ((kLowerBound >> kPrecision) << 8) * freq;
    while (state >= x_max) {
      bytes.push_back(static_cast<uint8_t>(state & 0xFF));
      state >>= 8;
    }
    state = ((state / freq) << kPrecision) + (state % freq) + start;
  }

  inline void put_bits(uint32_t val, uint32_t nbits) {
    const uint32_t x_max = (kLowerBound >> nbits) << 8;
    while (state >= x_max) {
      bytes.push_back(static_cast<uint8_t>(state & 0xFF));
      state >>= 8;
    }
    state = (state << nbits) | val;
  }

  // Serialized size: 4-byte state + renorm bytes.
  int flush(uint8_t* out, int capacity) const {
    const int n = static_cast<int>(bytes.size()) + 4;
    if (n > capacity) return -1;
    out[0] = static_cast<uint8_t>(state & 0xFF);
    out[1] = static_cast<uint8_t>((state >> 8) & 0xFF);
    out[2] = static_cast<uint8_t>((state >> 16) & 0xFF);
    out[3] = static_cast<uint8_t>((state >> 24) & 0xFF);
    // Bytes were emitted oldest-first; decoder needs newest-first.
    for (size_t i = 0; i < bytes.size(); ++i) {
      out[4 + i] = bytes[bytes.size() - 1 - i];
    }
    return n;
  }
};

struct Decoder {
  uint32_t state = 0;
  const uint8_t* ptr = nullptr;
  const uint8_t* end = nullptr;

  void init(const uint8_t* stream, int nbytes) {
    state = static_cast<uint32_t>(stream[0]) |
            (static_cast<uint32_t>(stream[1]) << 8) |
            (static_cast<uint32_t>(stream[2]) << 16) |
            (static_cast<uint32_t>(stream[3]) << 24);
    ptr = stream + 4;
    end = stream + nbytes;
  }

  inline uint32_t peek() const { return state & kProbMask; }

  inline void advance(uint32_t start, uint32_t freq) {
    state = freq * (state >> kPrecision) + (state & kProbMask) - start;
    while (state < kLowerBound && ptr < end) {
      state = (state << 8) | *ptr++;
    }
  }

  inline uint32_t get_bits(uint32_t nbits) {
    const uint32_t val = state & ((1u << nbits) - 1);
    state >>= nbits;
    while (state < kLowerBound && ptr < end) {
      state = (state << 8) | *ptr++;
    }
    return val;
  }
};

// Zigzag mapping for escaped values relative to the regular range [0, maxv).
inline uint32_t escape_raw(int32_t value, int32_t maxv) {
  return value < 0 ? static_cast<uint32_t>(-2 * value - 1)
                   : static_cast<uint32_t>(2 * (value - maxv));
}

inline int32_t unescape_raw(uint32_t raw, int32_t maxv) {
  return (raw & 1u) ? -static_cast<int32_t>((raw + 1) >> 1)
                    : maxv + static_cast<int32_t>(raw >> 1);
}

// Per-CDF coarse index over the top 8 bits of the 16-bit probability word:
// lut[r * 257 + b] = largest symbol s with cdf_r[s] <= (b << 8). Narrows the
// decoder's per-symbol search to the handful of symbols inside one bucket
// (typically 0-1 binary steps instead of ~6 over a 66-entry CDF). Build
// cost is ncdfs * 256, amortized over millions of symbols.
std::vector<uint16_t> bucket_lut(const int32_t* cdfs, int ncdfs, int cdf_stride,
                                 const int32_t* cdf_lengths) {
  std::vector<uint16_t> bucket(static_cast<size_t>(ncdfs) * 257);
  for (int r = 0; r < ncdfs; ++r) {
    const int32_t len = cdf_lengths[r];
    if (len < 3 || len > cdf_stride) continue;  // unused padding row
    const int32_t* cdf = cdfs + static_cast<size_t>(r) * cdf_stride;
    uint16_t* lut = bucket.data() + static_cast<size_t>(r) * 257;
    int s = 0;
    for (int b = 0; b < 256; ++b) {
      while (s + 1 < len - 1 && cdf[s + 1] <= (b << 8)) ++s;
      lut[b] = static_cast<uint16_t>(s);
    }
    lut[256] = static_cast<uint16_t>(len - 2);
  }
  return bucket;
}

// Decode one stream of n symbols against ``bucket`` (bucket_lut of the same
// tables). Returns 0 on success, -2 on malformed input.
template <typename Index, typename Symbol>
int decode_stream(const uint8_t* stream, int nbytes, const Index* indexes, int n,
                  const int32_t* cdfs, int ncdfs, int cdf_stride,
                  const int32_t* cdf_lengths, const int32_t* offsets,
                  const uint16_t* bucket, Symbol* out_symbols) {
  if (nbytes < 4) return -2;
  Decoder dec;
  dec.init(stream, nbytes);

  for (int i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -2;
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * cdf_stride;
    const int32_t len = cdf_lengths[idx];
    if (len < 3 || len > cdf_stride) return -2;
    const int32_t maxv = len - 2;

    const uint32_t cf = dec.peek();
    // Binary search for symbol s with cdf[s] <= cf < cdf[s+1], bounded
    // by the bucket index.
    const uint16_t* lut = bucket + static_cast<size_t>(idx) * 257;
    int lo = lut[cf >> 8];
    int hi = static_cast<int>(lut[(cf >> 8) + 1]) + 1;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(cdf[mid]) <= cf) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    int32_t value = lo;
    dec.advance(static_cast<uint32_t>(cdf[value]),
                static_cast<uint32_t>(cdf[value + 1] - cdf[value]));

    if (value == maxv) {
      // Chunks arrive lowest-7-bits first (see encoder comment).
      uint32_t raw = 0;
      int shift = 0;
      for (;;) {
        const uint32_t chunk = dec.get_bits(8);
        raw |= (chunk >> 1) << shift;
        shift += 7;
        if ((chunk & 1u) == 0) break;
      }
      value = unescape_raw(raw, maxv);
    }
    out_symbols[i] = static_cast<Symbol>(value + offsets[idx]);
  }
  return 0;
}

}  // namespace

extern "C" {

// Encode n symbols. cdfs is row-major (ncdfs, cdf_stride) int32; row r is a
// quantized CDF valid through cdf_lengths[r] entries (cdf[0]=0,
// cdf[len-1]=65536; slot len-2 is the escape symbol). symbols[i] is coded
// against row indexes[i] with value = symbols[i] - offsets[indexes[i]].
// Returns the number of bytes written to out, or -1 if out_capacity is too
// small, or -2 on malformed inputs.
int tpuvc_torch_rans_encode(const int32_t* symbols, const int32_t* indexes, int n,
                      const int32_t* cdfs, int ncdfs, int cdf_stride,
                      const int32_t* cdf_lengths, const int32_t* offsets,
                      uint8_t* out, int out_capacity) {
  Encoder enc;
  enc.bytes.reserve(static_cast<size_t>(n) * 2 + 16);
  for (int i = n - 1; i >= 0; --i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -2;
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * cdf_stride;
    const int32_t len = cdf_lengths[idx];
    if (len < 3 || len > cdf_stride) return -2;
    const int32_t maxv = len - 2;  // escape slot index
    int32_t value = symbols[i] - offsets[idx];

    if (value < 0 || value >= maxv) {
      // Push the bypass payload first (decoder reads it after the escape
      // symbol). 8-bit chunks: 7 payload bits + continuation bit. rANS is
      // LIFO, so the decoder reads chunks in reverse push order: we push
      // high-bits chunks first so the decoder receives low bits first.
      // The continuation bit marks "more chunks follow in decode order".
      uint32_t raw = escape_raw(value, maxv);
      int nchunks = 1;
      for (uint32_t r = raw >> 7; r != 0; r >>= 7) ++nchunks;
      for (int c = nchunks - 1; c >= 0; --c) {
        const uint32_t payload = (raw >> (7 * c)) & 0x7F;
        const uint32_t cont = (c < nchunks - 1) ? 1u : 0u;
        enc.put_bits((payload << 1) | cont, 8);
      }
      value = maxv;
    }
    const uint32_t start = static_cast<uint32_t>(cdf[value]);
    const uint32_t freq = static_cast<uint32_t>(cdf[value + 1] - cdf[value]);
    if (freq == 0) return -2;
    enc.put(start, freq);
  }
  return enc.flush(out, out_capacity);
}

// Decode n symbols written by tpuvc_torch_rans_encode with the same tables.
// Returns 0 on success, -2 on malformed input.
int tpuvc_torch_rans_decode(const uint8_t* stream, int nbytes, const int32_t* indexes,
                      int n, const int32_t* cdfs, int ncdfs, int cdf_stride,
                      const int32_t* cdf_lengths, const int32_t* offsets,
                      int32_t* out_symbols) {
  const std::vector<uint16_t> lut = bucket_lut(cdfs, ncdfs, cdf_stride, cdf_lengths);
  return decode_stream(stream, nbytes, indexes, n, cdfs, ncdfs, cdf_stride, cdf_lengths,
                       offsets, lut.data(), out_symbols);
}

// Decode nstreams independent streams of n symbols each, one thread a
// stream: stream k against the uint8 table indexes indexes[k * n ...], into
// out_symbols[k * n ...] as int16 (the width the device quantizes symbols
// to; a wider value wraps, as a cast would). Returns 0 on success, else the
// first failing stream's code.
int tpuvc_torch_rans_decode_batch(const uint8_t* const* streams, const int32_t* nbytes,
                            int nstreams, const uint8_t* indexes, int n,
                            const int32_t* cdfs, int ncdfs, int cdf_stride,
                            const int32_t* cdf_lengths, const int32_t* offsets,
                            int16_t* out_symbols) {
  const std::vector<uint16_t> lut = bucket_lut(cdfs, ncdfs, cdf_stride, cdf_lengths);
  std::vector<int> rcs(static_cast<size_t>(nstreams), 0);
  auto run = [&](int k) {
    const size_t at = static_cast<size_t>(k) * n;
    rcs[k] = decode_stream(streams[k], nbytes[k], indexes + at, n, cdfs, ncdfs, cdf_stride,
                           cdf_lengths, offsets, lut.data(), out_symbols + at);
  };
  std::vector<std::thread> threads;
  for (int k = 1; k < nstreams; ++k) threads.emplace_back(run, k);
  if (nstreams > 0) run(0);
  for (auto& t : threads) t.join();
  for (int rc : rcs) {
    if (rc != 0) return rc;
  }
  return 0;
}

// PMF -> quantized CDF (the C++ twin of tpuvc_torch/entropy/cdf.py::
// pmf_to_quantized_cdf; computes what tpuvc's tpuvc_pmf_to_quantized_cdf
// computes). Every symbol gets a frequency >= 1; the flooring deficit is
// granted round-robin to the largest-probability symbols (a stable order,
// ties by index), a surplus is taken one at a time from the largest
// frequency. Returns 0 on success, -2 on malformed input.
int tpuvc_torch_pmf_to_quantized_cdf(const double* pmf, int n, int precision,
                                     int32_t* out_cdf /* size n+1 */) {
  if (n < 1 || precision < 1 || precision > 24) return -2;
  const int64_t total = int64_t{1} << precision;
  if (n > total) return -2;

  std::vector<double> p(pmf, pmf + n);
  double norm = 0.0;
  for (double& v : p) {
    if (!(v == v) || v > 1e300) return -2;  // NaN / inf
    if (v < 0.0) v = 0.0;
    norm += v;
  }
  std::vector<int64_t> freqs(n);
  if (norm <= 0.0) {
    const int64_t base = total / n;
    const int64_t rem = total - base * n;
    for (int i = 0; i < n; ++i) freqs[i] = base + (i < rem ? 1 : 0);
  } else {
    int64_t sum = 0;
    for (int i = 0; i < n; ++i) {
      int64_t f = static_cast<int64_t>(p[i] / norm * total);
      if (f < 1) f = 1;
      freqs[i] = f;
      sum += f;
    }
    const int64_t deficit = total - sum;
    if (deficit > 0) {
      std::vector<int> order(n);
      for (int i = 0; i < n; ++i) order[i] = i;
      std::stable_sort(order.begin(), order.end(),
                       [&](int a, int b) { return p[a] > p[b]; });
      for (int64_t k = 0; k < deficit; ++k) freqs[order[k % n]] += 1;
    } else {
      for (int64_t k = 0; k < -deficit; ++k) {
        int imax = 0;
        for (int i = 1; i < n; ++i) {
          if (freqs[i] > freqs[imax]) imax = i;
        }
        if (freqs[imax] <= 1) return -2;
        freqs[imax] -= 1;
      }
    }
  }
  out_cdf[0] = 0;
  int64_t acc = 0;
  for (int i = 0; i < n; ++i) {
    acc += freqs[i];
    out_cdf[i + 1] = static_cast<int32_t>(acc);
  }
  return acc == total ? 0 : -2;
}

}  // extern "C"
