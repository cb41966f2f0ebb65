// WebP bitstream decoder for the port's host image route
// (vtc_tpu_torch/data/webp.py), which the machine with the card needs because
// it has no PIL. The JAX package reads every image with
// PIL.Image.open(...).convert("RGB"); PIL decodes a WebP with libwebp's
// WebPAnimDecoder, and this file gives the same pixels bit for bit:
//
// * VP8L, the lossless format: the 14-bit size header; the four transforms
//   (predictor, cross-colour, subtract-green, colour indexing with its pixel
//   bundling), inverted in the reverse of their order in the stream; the
//   canonical prefix codes (simple codes of 1 or 2 symbols, a code of one
//   symbol read with zero bits, code lengths coded by a code-length code),
//   meta prefix codes chosen per tile by an entropy image, the colour cache,
//   and LZ77 backward references with the 120-entry distance map;
// * VP8, the lossy format, one intra key frame: the boolean decoder, the
//   segment and filter headers, 1, 2, 4 or 8 token partitions, the
//   quantizer tables, the coefficient probabilities with their updates, the
//   16x16, 4x4 and chroma intra predictors, the inverse WHT and DCT, and the
//   simple and normal loop filters; YUV 4:2:0 becomes RGB through libwebp's
//   "fancy" upsampler (src/dsp/upsampling.c, the 9-3-3-1 weights, computed
//   in two steps) and its 14-bit fixed-point VP8YuvToRgb (src/dsp/yuv.h);
// * the ALPH chunk of a lossy image: raw, or the green channel of a VP8L
//   stream without its size header; then the none, horizontal, vertical or
//   gradient unfilter.
//
// Where the stream runs out is decided as libwebp decides it: the boolean
// decoder flags the end when it must read a byte past its partition, and a
// partition that ends before its last macroblock is a refusal ("Premature
// end-of-file"); the VP8L reader flags the end when more bits are consumed
// than the chunk holds (or than 64, for a chunk of under 8 bytes).
//
// The container (RIFF, VP8X, ANMF, the demuxer's validity rules, the canvas
// and frame 0's place on it) is parsed in Python; this file decodes one
// frame's bitstreams. Every read is bounded by the buffer the caller passes:
// the bytes are untrusted (the server decodes queries).
//
// Built at first use by vtc_tpu_torch/ops/_build.py (g++ -O3 -shared -fPIC),
// loaded with ctypes. With -DVTC_WEBP_MAIN it is a standalone program that
// decodes a file of cases (see main() at the end), for a sanitizer build.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kBadVp8Header = 1,        // frame header: not a key frame, bad signature, size
  kVp8Partition0 = 2,       // partition 0 longer than the data
  kVp8Partitions = 3,       // token partition sizes past the data
  kVp8Premature0 = 4,       // partition 0 ended before the last macroblock row
  kVp8PrematureTokens = 5,  // a token partition ended before its last macroblock
  kVp8HeaderEof = 6,        // partition 0 ended within the frame header
  kBadVp8lHeader = 7,       // signature, version or size of a VP8L stream
  kVp8lBitstream = 8,       // an invalid prefix code, transform or colour cache
  kVp8lEof = 9,             // the VP8L stream ended before its last pixel
  kVp8lBackRef = 10,        // a backward reference before the image or past it
  kBadAlphaHeader = 11,     // the ALPH byte: method, pre-processing or reserved bits
  kAlphaTruncated = 12,     // raw alpha shorter than the image
  kAlphaBitstream = 13,     // the alpha's VP8L stream failed
  kSizeMismatch = 14,       // the bitstream's size is not the one the caller parsed
  kNoMemory = 15,
};

// ===========================================================================
// VP8L
// ===========================================================================

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kCodeLengthCodes = 19;
constexpr int kHuffmanTableBits = 8;
constexpr int kLengthsTableBits = 7;
constexpr int kMaxAllowedCodeLength = 15;
constexpr int kMaxCacheBits = 11;
constexpr uint32_t kArgbBlack = 0xff000000u;

const uint8_t kCodeLengthCodeOrder[kCodeLengthCodes] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                         7,  8,  9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeLengthExtraBits[3] = {2, 3, 7};
const uint8_t kCodeLengthRepeatOffsets[3] = {3, 3, 11};
const uint16_t kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, kNumLiteralCodes,
                                   kNumLiteralCodes, kNumLiteralCodes, kNumDistanceCodes};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };

// the distance map of the lossless specification: (yoffset << 4) | (8 - xoffset)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

// ---- the VP8L bit reader: a 64-bit window read least significant bit first
struct LBitReader {
  uint64_t val = 0;         // the window
  const uint8_t* buf = nullptr;
  size_t len = 0;           // bytes of the stream
  size_t pos = 0;           // bytes loaded into the window
  int bit_pos = 0;          // bits of the window consumed
  bool eos = false;         // more bits consumed than the stream holds
};

void LInit(LBitReader* br, const uint8_t* start, size_t length) {
  br->len = length;
  br->val = 0;
  br->bit_pos = 0;
  br->eos = false;
  size_t n = length < 8 ? length : 8;
  for (size_t i = 0; i < n; ++i) br->val |= static_cast<uint64_t>(start[i]) << (8 * i);
  br->pos = n;
  br->buf = start;
}

inline bool LIsEndOfStream(const LBitReader* br) {
  return br->eos || (br->pos == br->len && br->bit_pos > 64);
}

inline void LSetEndOfStream(LBitReader* br) {
  br->eos = true;
  br->bit_pos = 0;  // the reads that follow see a defined (and ignored) window
}

void LShiftBytes(LBitReader* br) {
  while (br->bit_pos >= 8 && br->pos < br->len) {
    br->val >>= 8;
    br->val |= static_cast<uint64_t>(br->buf[br->pos]) << 56;
    ++br->pos;
    br->bit_pos -= 8;
  }
  if (LIsEndOfStream(br)) LSetEndOfStream(br);
}

inline uint32_t LPrefetchBits(const LBitReader* br) {
  return static_cast<uint32_t>(br->val >> (br->bit_pos & 63));
}

inline void LFillBitWindow(LBitReader* br) {
  if (br->bit_pos >= 32) {
    if (br->pos + 8 < br->len) {  // four bytes at once, well inside the stream
      br->val >>= 32;
      br->bit_pos -= 32;
      uint32_t w = static_cast<uint32_t>(br->buf[br->pos]) |
                   static_cast<uint32_t>(br->buf[br->pos + 1]) << 8 |
                   static_cast<uint32_t>(br->buf[br->pos + 2]) << 16 |
                   static_cast<uint32_t>(br->buf[br->pos + 3]) << 24;
      br->val |= static_cast<uint64_t>(w) << 32;
      br->pos += 4;
      return;
    }
    LShiftBytes(br);
  }
}

uint32_t LReadBits(LBitReader* br, int n_bits) {
  if (!br->eos && n_bits <= 24) {
    uint32_t val = LPrefetchBits(br) & ((1u << n_bits) - 1);
    br->bit_pos += n_bits;
    LShiftBytes(br);
    return val;
  }
  LSetEndOfStream(br);
  return 0;
}

// ---- canonical prefix codes, as two-level lookup tables (root of 8 bits)
struct HuffmanCode {
  uint8_t bits;    // bits of the code, or (root entry of a long code) of the subtable index
  uint16_t value;  // the symbol, or the offset of the subtable
};

inline uint32_t GetNextKey(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void ReplicateValue(HuffmanCode* table, int step, int end, HuffmanCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int NextTableBitSize(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxAllowedCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// The size of the table of the code with these lengths, 0 where the lengths
// make no valid code (all zero, a length over 15, over-subscribed, or not
// complete, unless a single symbol: then a code of zero bits). With `table`
// null it only checks.
int BuildHuffmanTable(std::vector<HuffmanCode>* table, int root_bits, const int* code_lengths,
                      int code_lengths_size) {
  int count[kMaxAllowedCodeLength + 1] = {0};
  int offset[kMaxAllowedCodeLength + 1];
  for (int s = 0; s < code_lengths_size; ++s) {
    if (code_lengths[s] > kMaxAllowedCodeLength) return 0;
    ++count[code_lengths[s]];
  }
  if (count[0] == code_lengths_size) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxAllowedCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(code_lengths_size);
  for (int s = 0; s < code_lengths_size; ++s) {
    if (code_lengths[s] > 0) sorted[offset[code_lengths[s]]++] = static_cast<uint16_t>(s);
  }
  int total_size = 1 << root_bits;
  if (offset[kMaxAllowedCodeLength] == 1) {  // one symbol: read with zero bits
    if (table) {
      table->assign(total_size, HuffmanCode{0, sorted[0]});
    }
    return total_size;
  }
  // a first pass counts the size, the second fills
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      if (!table) return total_size;
      table->assign(total_size, HuffmanCode{0, 0});
    }
    int cnt[kMaxAllowedCodeLength + 1];
    memcpy(cnt, count, sizeof(cnt));
    HuffmanCode* root = pass == 1 ? table->data() : nullptr;
    size_t tab = 0;  // offset of the current (sub)table
    int size = 1 << root_bits;
    uint32_t low = 0xffffffffu;
    const uint32_t mask = (1u << root_bits) - 1;
    uint32_t key = 0;
    int num_nodes = 1, num_open = 1;
    int table_bits = root_bits, table_size = 1 << root_bits;
    int symbol = 0;
    int len, step;
    for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      for (; cnt[len] > 0; --cnt[len]) {
        if (root) ReplicateValue(&root[key], step, table_size,
                                 HuffmanCode{static_cast<uint8_t>(len), sorted[symbol]});
        ++symbol;
        key = GetNextKey(key, len);
      }
    }
    for (len = root_bits + 1, step = 2; len <= kMaxAllowedCodeLength; ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      for (; cnt[len] > 0; --cnt[len]) {
        if ((key & mask) != low) {
          tab += table_size;
          table_bits = NextTableBitSize(cnt, len, root_bits);
          table_size = 1 << table_bits;
          size += table_size;
          low = key & mask;
          if (root) {
            root[low].bits = static_cast<uint8_t>(table_bits + root_bits);
            root[low].value = static_cast<uint16_t>(tab - low);
          }
        }
        if (root) ReplicateValue(&root[tab + (key >> root_bits)], step, table_size,
                                 HuffmanCode{static_cast<uint8_t>(len - root_bits),
                                             sorted[symbol]});
        ++symbol;
        key = GetNextKey(key, len);
      }
    }
    if (num_nodes != 2 * offset[kMaxAllowedCodeLength] - 1) return 0;
    total_size = size;
  }
  return total_size;
}

inline int ReadSymbol(const HuffmanCode* table, LBitReader* br) {
  uint32_t val = LPrefetchBits(br);
  table += val & ((1u << kHuffmanTableBits) - 1);
  int nbits = table->bits - kHuffmanTableBits;
  if (nbits > 0) {
    br->bit_pos += kHuffmanTableBits;
    val = LPrefetchBits(br);
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br->bit_pos += table->bits;
  return table->value;
}

// the five codes of one meta code
struct HTreeGroup {
  std::vector<HuffmanCode> htrees[5];
};

struct Transform {
  int type = 0;  // 0 predictor, 1 cross-colour, 2 subtract-green, 3 colour indexing
  int bits = 0;
  int xsize = 0, ysize = 0;  // the image's size where the transform was read: its inverse's output
  std::vector<uint32_t> data;
};

struct Metadata {
  int color_cache_bits = 0;
  int huffman_subsample_bits = 0;
  int huffman_xsize = 0;
  int huffman_mask = ~0;
  std::vector<uint32_t> huffman_image;  // group of each tile
  std::vector<HTreeGroup> groups;
};

struct VP8LDecoder {
  LBitReader br;
  int status = kOk;
  Transform transforms[4];
  int next_transform = 0;
  uint32_t transforms_seen = 0;
};

inline int SubSampleSize(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int GetCopyDistance(int distance_symbol, LBitReader* br) {
  if (distance_symbol < 4) return distance_symbol + 1;
  int extra_bits = (distance_symbol - 2) >> 1;
  int offset = (2 + (distance_symbol & 1)) << extra_bits;
  return offset + static_cast<int>(LReadBits(br, extra_bits)) + 1;
}

inline int PlaneCodeToDistance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  int dist_code = kCodeToPlane[plane_code - 1];
  int yoffset = dist_code >> 4;
  int xoffset = 8 - (dist_code & 0xf);
  int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

bool ReadHuffmanCodeLengths(VP8LDecoder* dec, const int* code_length_code_lengths,
                            int num_symbols, int* code_lengths) {
  LBitReader* br = &dec->br;
  std::vector<HuffmanCode> table;
  if (!BuildHuffmanTable(&table, kLengthsTableBits, code_length_code_lengths,
                         kCodeLengthCodes)) {
    return false;
  }
  int max_symbol;
  if (LReadBits(br, 1)) {
    int length_nbits = 2 + 2 * static_cast<int>(LReadBits(br, 3));
    max_symbol = 2 + static_cast<int>(LReadBits(br, length_nbits));
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int prev_code_len = 8;
  int symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    LFillBitWindow(br);
    const HuffmanCode& p = table[LPrefetchBits(br) & ((1u << kLengthsTableBits) - 1)];
    br->bit_pos += p.bits;
    int code_len = p.value;
    if (code_len < 16) {
      code_lengths[symbol++] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      bool use_prev = code_len == 16;
      int slot = code_len - 16;
      int repeat = static_cast<int>(LReadBits(br, kCodeLengthExtraBits[slot])) +
                   kCodeLengthRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) return false;
      int length = use_prev ? prev_code_len : 0;
      while (repeat-- > 0) code_lengths[symbol++] = length;
    }
  }
  return true;
}

// Reads one prefix code; `table` null checks it without keeping it. Returns
// the table's size, 0 on a fault.
int ReadHuffmanCode(int alphabet_size, VP8LDecoder* dec, int* code_lengths,
                    std::vector<HuffmanCode>* table) {
  LBitReader* br = &dec->br;
  bool ok;
  memset(code_lengths, 0, alphabet_size * sizeof(*code_lengths));
  if (LReadBits(br, 1)) {  // simple: 1 or 2 symbols, each coded with 1 bit
    int num_symbols = static_cast<int>(LReadBits(br, 1)) + 1;
    int first_symbol_len_code = static_cast<int>(LReadBits(br, 1));
    int symbol = static_cast<int>(LReadBits(br, first_symbol_len_code == 0 ? 1 : 8));
    code_lengths[symbol] = 1;  // code_lengths holds 256 or more entries
    if (num_symbols == 2) {
      symbol = static_cast<int>(LReadBits(br, 8));
      code_lengths[symbol] = 1;
    }
    ok = true;
  } else {
    int code_length_code_lengths[kCodeLengthCodes] = {0};
    int num_codes = static_cast<int>(LReadBits(br, 4)) + 4;
    for (int i = 0; i < num_codes; ++i) {
      code_length_code_lengths[kCodeLengthCodeOrder[i]] = static_cast<int>(LReadBits(br, 3));
    }
    ok = ReadHuffmanCodeLengths(dec, code_length_code_lengths, alphabet_size, code_lengths);
  }
  ok = ok && !br->eos;
  int size = 0;
  if (ok) size = BuildHuffmanTable(table, kHuffmanTableBits, code_lengths, alphabet_size);
  if (!ok || size == 0) dec->status = kVp8lBitstream;
  return ok ? size : 0;
}

bool DecodeImageStream(int xsize, int ysize, bool is_level0, VP8LDecoder* dec,
                       std::vector<uint32_t>* decoded, Metadata* hdr_out, int* out_xsize);

bool ReadHuffmanCodes(VP8LDecoder* dec, int xsize, int ysize, int color_cache_bits,
                      bool allow_recursion, Metadata* hdr) {
  LBitReader* br = &dec->br;
  int num_htree_groups_max = 1;
  std::vector<int> mapping;  // group index in the image -> stored group, -1 unused
  if (allow_recursion && LReadBits(br, 1)) {
    int precision = 2 + static_cast<int>(LReadBits(br, 3));
    int hx = SubSampleSize(xsize, precision), hy = SubSampleSize(ysize, precision);
    if (!DecodeImageStream(hx, hy, false, dec, &hdr->huffman_image, nullptr, nullptr)) {
      return false;
    }
    hdr->huffman_subsample_bits = precision;
    for (uint32_t& v : hdr->huffman_image) {
      v = (v >> 8) & 0xffff;  // red and green: the group
      if (static_cast<int>(v) >= num_htree_groups_max) num_htree_groups_max = v + 1;
    }
  }
  if (br->eos) {
    dec->status = kVp8lEof;
    return false;
  }
  // As libwebp: past 1000 groups, or more groups than pixels, only the groups
  // the image uses are kept (the others are read and checked); else all.
  int num_htree_groups = num_htree_groups_max;
  mapping.resize(num_htree_groups_max);
  if (num_htree_groups_max > 1000 ||
      static_cast<int64_t>(num_htree_groups_max) > static_cast<int64_t>(xsize) * ysize) {
    mapping.assign(num_htree_groups_max, -1);
    num_htree_groups = 0;
    for (uint32_t& v : hdr->huffman_image) {
      if (mapping[v] == -1) mapping[v] = num_htree_groups++;
      v = mapping[v];
    }
  } else {
    for (int i = 0; i < num_htree_groups_max; ++i) mapping[i] = i;
  }
  int max_alphabet = kAlphabetSize[0] + (color_cache_bits > 0 ? 1 << color_cache_bits : 0);
  std::vector<int> code_lengths(max_alphabet);
  hdr->groups.resize(num_htree_groups);
  std::vector<HuffmanCode> scratch;
  for (int i = 0; i < num_htree_groups_max; ++i) {
    for (int j = 0; j < 5; ++j) {
      int alphabet_size = kAlphabetSize[j];
      if (j == 0 && color_cache_bits > 0) alphabet_size += 1 << color_cache_bits;
      std::vector<HuffmanCode>* table =
          mapping[i] == -1 ? nullptr : &hdr->groups[mapping[i]].htrees[j];
      if (!ReadHuffmanCode(alphabet_size, dec, code_lengths.data(), table)) return false;
    }
  }
  return true;
}

bool ReadTransform(int* xsize, int ysize, VP8LDecoder* dec) {
  LBitReader* br = &dec->br;
  int type = static_cast<int>(LReadBits(br, 2));
  if (dec->transforms_seen & (1u << type)) return false;
  dec->transforms_seen |= 1u << type;
  Transform* t = &dec->transforms[dec->next_transform++];
  t->type = type;
  t->xsize = *xsize;
  t->ysize = ysize;
  switch (type) {
    case 0:  // predictor
    case 1:  // cross-colour
      t->bits = 2 + static_cast<int>(LReadBits(br, 3));
      return DecodeImageStream(SubSampleSize(t->xsize, t->bits), SubSampleSize(ysize, t->bits),
                               false, dec, &t->data, nullptr, nullptr);
    case 3: {  // colour indexing
      int num_colors = static_cast<int>(LReadBits(br, 8)) + 1;
      int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = SubSampleSize(t->xsize, bits);
      t->bits = bits;
      std::vector<uint32_t> palette;
      if (!DecodeImageStream(num_colors, 1, false, dec, &palette, nullptr, nullptr)) return false;
      // delta-coded; entries past the palette are transparent black (0)
      int final_num_colors = 1 << (8 >> bits);
      t->data.assign(final_num_colors, 0);
      uint8_t* out = reinterpret_cast<uint8_t*>(t->data.data());
      const uint8_t* in = reinterpret_cast<const uint8_t*>(palette.data());
      for (int i = 0; i < 4; ++i) out[i] = in[i];
      for (int i = 4; i < 4 * num_colors; ++i) out[i] = static_cast<uint8_t>(in[i] + out[i - 4]);
      return true;
    }
    default:  // subtract green
      return true;
  }
}

inline const HTreeGroup* GetHtreeGroupForPos(const Metadata* hdr, int x, int y) {
  if (hdr->huffman_image.empty()) return &hdr->groups[0];
  int bits = hdr->huffman_subsample_bits;
  return &hdr->groups[hdr->huffman_image[hdr->huffman_xsize * (y >> bits) + (x >> bits)]];
}

struct ColorCache {
  std::vector<uint32_t> colors;
  int hash_shift = 0;
  void init(int bits) {
    colors.assign(1u << bits, 0);
    hash_shift = 32 - bits;
  }
  inline void insert(uint32_t argb) { colors[(argb * 0x1e35a7bdu) >> hash_shift] = argb; }
};

// LZ77-coded ARGB pixels (the 32-bit path of libwebp's DecodeImageData, for
// a stream decoded at once): false on a fault, with dec->status set.
bool DecodeImageData(VP8LDecoder* dec, uint32_t* data, int width, int height,
                     const Metadata* hdr) {
  LBitReader* br = &dec->br;
  int row = 0, col = 0;
  uint32_t* src = data;
  uint32_t* last_cached = src;
  uint32_t* const src_end = data + static_cast<size_t>(width) * height;
  const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
  const int cache_size = hdr->color_cache_bits > 0 ? 1 << hdr->color_cache_bits : 0;
  const int color_cache_limit = len_code_limit + cache_size;
  ColorCache cache;
  if (cache_size) cache.init(hdr->color_cache_bits);
  const int mask = hdr->huffman_mask;
  const HTreeGroup* group = src < src_end ? GetHtreeGroupForPos(hdr, col, row) : nullptr;
  while (src < src_end) {
    if ((col & mask) == 0) group = GetHtreeGroupForPos(hdr, col, row);
    LFillBitWindow(br);
    int code = ReadSymbol(group->htrees[GREEN].data(), br);
    if (LIsEndOfStream(br)) break;
    if (code < kNumLiteralCodes) {
      {
        const int red = ReadSymbol(group->htrees[RED].data(), br);
        LFillBitWindow(br);
        const int blue = ReadSymbol(group->htrees[BLUE].data(), br);
        const int alpha = ReadSymbol(group->htrees[ALPHA].data(), br);
        if (LIsEndOfStream(br)) break;
        *src = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
      }
    advance_by_one:
      ++src;
      ++col;
      if (col >= width) {
        col = 0;
        ++row;
        if (cache_size) {
          while (last_cached < src) cache.insert(*last_cached++);
        }
      }
    } else if (code < len_code_limit) {
      int length = GetCopyDistance(code - kNumLiteralCodes, br);
      int dist_symbol = ReadSymbol(group->htrees[DIST].data(), br);
      LFillBitWindow(br);
      int dist_code = GetCopyDistance(dist_symbol, br);
      int dist = PlaneCodeToDistance(width, dist_code);
      if (LIsEndOfStream(br)) break;
      if (src - data < static_cast<ptrdiff_t>(dist) ||
          src_end - src < static_cast<ptrdiff_t>(length)) {
        dec->status = kVp8lBackRef;
        return false;
      }
      for (int i = 0; i < length; ++i) src[i] = src[i - dist];  // overlapping copies repeat
      src += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (col & mask) group = GetHtreeGroupForPos(hdr, col, row);
      if (cache_size) {
        while (last_cached < src) cache.insert(*last_cached++);
      }
    } else if (code < color_cache_limit) {
      int key = code - len_code_limit;
      while (last_cached < src) cache.insert(*last_cached++);
      *src = cache.colors[key];
      goto advance_by_one;
    } else {
      dec->status = kVp8lBitstream;
      return false;
    }
  }
  br->eos = LIsEndOfStream(br);
  if (br->eos) {
    dec->status = kVp8lEof;
    return false;
  }
  return true;
}

// One image stream: the transforms (level 0 only), the colour cache, the
// prefix codes (meta codes at level 0 only). At level 0 the caller decodes
// the pixels with the returned metadata; otherwise they are decoded here.
bool DecodeImageStream(int xsize, int ysize, bool is_level0, VP8LDecoder* dec,
                       std::vector<uint32_t>* decoded, Metadata* hdr_out, int* out_xsize) {
  LBitReader* br = &dec->br;
  int transform_xsize = xsize;
  bool ok = true;
  if (is_level0) {
    while (ok && LReadBits(br, 1)) ok = ReadTransform(&transform_xsize, ysize, dec);
    if (!ok) {
      if (dec->status == kOk) dec->status = kVp8lBitstream;
      return false;
    }
  }
  Metadata local;
  Metadata* hdr = is_level0 ? hdr_out : &local;
  if (LReadBits(br, 1)) {
    int bits = static_cast<int>(LReadBits(br, 4));
    if (bits < 1 || bits > kMaxCacheBits) {
      dec->status = kVp8lBitstream;
      return false;
    }
    hdr->color_cache_bits = bits;
  }
  if (!ReadHuffmanCodes(dec, transform_xsize, ysize, hdr->color_cache_bits, is_level0, hdr)) {
    if (dec->status == kOk) dec->status = kVp8lBitstream;
    return false;
  }
  int num_bits = hdr->huffman_subsample_bits;
  hdr->huffman_xsize = SubSampleSize(transform_xsize, num_bits);
  hdr->huffman_mask = num_bits == 0 ? ~0 : (1 << num_bits) - 1;
  if (is_level0) {
    *out_xsize = transform_xsize;
    return true;
  }
  decoded->assign(static_cast<size_t>(transform_xsize) * ysize, 0);
  return DecodeImageData(dec, decoded->data(), transform_xsize, ysize, hdr) && !br->eos;
}

// ---- the inverse transforms

inline uint32_t AddPixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t Average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}

inline uint32_t Clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline int AddSubtractComponentFull(int a, int b, int c) {
  return static_cast<int>(Clip255(static_cast<uint32_t>(a + b - c)));
}

inline uint32_t ClampedAddSubtractFull(uint32_t c0, uint32_t c1, uint32_t c2) {
  int a = AddSubtractComponentFull(c0 >> 24, c1 >> 24, c2 >> 24);
  int r = AddSubtractComponentFull((c0 >> 16) & 0xff, (c1 >> 16) & 0xff, (c2 >> 16) & 0xff);
  int g = AddSubtractComponentFull((c0 >> 8) & 0xff, (c1 >> 8) & 0xff, (c2 >> 8) & 0xff);
  int b = AddSubtractComponentFull(c0 & 0xff, c1 & 0xff, c2 & 0xff);
  return (static_cast<uint32_t>(a) << 24) | (r << 16) | (g << 8) | b;
}

inline int AddSubtractComponentHalf(int a, int b) {
  return static_cast<int>(Clip255(static_cast<uint32_t>(a + (a - b) / 2)));
}

inline uint32_t ClampedAddSubtractHalf(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t ave = Average2(c0, c1);
  int a = AddSubtractComponentHalf(ave >> 24, c2 >> 24);
  int r = AddSubtractComponentHalf((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  int g = AddSubtractComponentHalf((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  int b = AddSubtractComponentHalf(ave & 0xff, c2 & 0xff);
  return (static_cast<uint32_t>(a) << 24) | (r << 16) | (g << 8) | b;
}

inline int Sub3(int a, int b, int c) {
  int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

inline uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {
  int pa_minus_pb = Sub3(a >> 24, b >> 24, c >> 24) +
                    Sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                    Sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                    Sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

// predictor `mode` of the pixel whose left neighbour is `left` and whose
// row above starts at `top` (top[-1] top-left, top[1] top-right; the last
// pixel's top-right is the current row's first pixel, as the rows lie in memory)
inline uint32_t Predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return Average2(Average2(left, top[1]), top[0]);
    case 6: return Average2(left, top[-1]);
    case 7: return Average2(left, top[0]);
    case 8: return Average2(top[-1], top[0]);
    case 9: return Average2(top[0], top[1]);
    case 10: return Average2(Average2(left, top[-1]), Average2(top[0], top[1]));
    case 11: return Select(top[0], left, top[-1]);
    case 12: return ClampedAddSubtractFull(left, top[0], top[-1]);
    case 13: return ClampedAddSubtractHalf(left, top[0], top[-1]);
    default: return kArgbBlack;  // 0, and 14 and 15 as libwebp reads them
  }
}

void InversePredictor(const Transform& t, uint32_t* px) {
  const int width = t.xsize;
  // the first row: black, then L
  px[0] = AddPixels(px[0], kArgbBlack);
  for (int x = 1; x < width; ++x) px[x] = AddPixels(px[x], px[x - 1]);
  const int tiles_per_row = SubSampleSize(width, t.bits);
  for (int y = 1; y < t.ysize; ++y) {
    uint32_t* out = px + static_cast<size_t>(y) * width;
    const uint32_t* up = out - width;
    const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles_per_row;
    out[0] = AddPixels(out[0], up[0]);  // the first column: T
    for (int x = 1; x < width; ++x) {
      int mode = (modes[x >> t.bits] >> 8) & 0xf;
      out[x] = AddPixels(out[x], Predict(mode, out[x - 1], up + x));
    }
  }
}

void InverseCrossColor(const Transform& t, uint32_t* px) {
  const int width = t.xsize;
  const int tiles_per_row = SubSampleSize(width, t.bits);
  for (int y = 0; y < t.ysize; ++y) {
    uint32_t* row = px + static_cast<size_t>(y) * width;
    const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles_per_row;
    for (int x = 0; x < width; ++x) {
      uint32_t code = codes[x >> t.bits];
      int8_t g2r = static_cast<int8_t>(code & 0xff);
      int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
      int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
      uint32_t argb = row[x];
      int8_t green = static_cast<int8_t>(argb >> 8);
      int new_red = (argb >> 16) & 0xff;
      int new_blue = argb & 0xff;
      new_red += (static_cast<int>(g2r) * green) >> 5;
      new_red &= 0xff;
      new_blue += (static_cast<int>(g2b) * green) >> 5;
      new_blue += (static_cast<int>(r2b) * static_cast<int8_t>(new_red)) >> 5;
      new_blue &= 0xff;
      row[x] = (argb & 0xff00ff00u) | (new_red << 16) | new_blue;
    }
  }
}

void AddGreen(uint32_t* px, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t argb = px[i];
    uint32_t green = (argb >> 8) & 0xff;
    uint32_t rb = ((argb & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
    px[i] = (argb & 0xff00ff00u) | rb;
  }
}

// colour indexing: the packed indices (green) of `in` (width packed) -> `out`
void InverseColorIndexing(const Transform& t, const uint32_t* in, uint32_t* out) {
  const int bits_per_pixel = 8 >> t.bits;
  const int count_mask = (1 << t.bits) - 1;
  const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
  const int packed_width = SubSampleSize(t.xsize, t.bits);
  for (int y = 0; y < t.ysize; ++y) {
    const uint32_t* src = in + static_cast<size_t>(y) * packed_width;
    uint32_t* dst = out + static_cast<size_t>(y) * t.xsize;
    uint32_t packed = 0;
    for (int x = 0; x < t.xsize; ++x) {
      if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
      dst[x] = t.data[packed & bit_mask];
      packed >>= bits_per_pixel;
    }
  }
}

// the transforms inverted, last read first: `px` (the decoded width) -> the
// image at its full width
std::vector<uint32_t> ApplyInverseTransforms(VP8LDecoder* dec, std::vector<uint32_t> px) {
  for (int n = dec->next_transform - 1; n >= 0; --n) {
    const Transform& t = dec->transforms[n];
    switch (t.type) {
      case 0: InversePredictor(t, px.data()); break;
      case 1: InverseCrossColor(t, px.data()); break;
      case 2: AddGreen(px.data(), px.size()); break;
      case 3: {
        std::vector<uint32_t> out(static_cast<size_t>(t.xsize) * t.ysize);
        InverseColorIndexing(t, px.data(), out.data());
        px.swap(out);
        break;
      }
    }
  }
  return px;
}

bool ReadImageInfo(LBitReader* br, int* width, int* height, int* has_alpha) {
  if (LReadBits(br, 8) != 0x2f) return false;
  *width = static_cast<int>(LReadBits(br, 14)) + 1;
  *height = static_cast<int>(LReadBits(br, 14)) + 1;
  *has_alpha = static_cast<int>(LReadBits(br, 1));
  if (LReadBits(br, 3) != 0) return false;
  return !br->eos;
}

// A VP8L image (its chunk's payload) -> ARGB pixels.
int DecodeVp8l(const uint8_t* data, size_t size, int width, int height,
               std::vector<uint32_t>* argb) {
  if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return kBadVp8lHeader;
  VP8LDecoder dec;
  LInit(&dec.br, data, size);
  int w, h, a;
  if (!ReadImageInfo(&dec.br, &w, &h, &a)) return kBadVp8lHeader;
  if (w != width || h != height) return kSizeMismatch;
  Metadata hdr;
  int xsize = 0;
  if (!DecodeImageStream(w, h, true, &dec, nullptr, &hdr, &xsize)) {
    return dec.status == kOk ? kVp8lBitstream : dec.status;
  }
  std::vector<uint32_t> px(static_cast<size_t>(xsize) * h);
  if (!DecodeImageData(&dec, px.data(), xsize, h, &hdr)) return dec.status;
  *argb = ApplyInverseTransforms(&dec, std::move(px));
  return kOk;
}

// ---- alpha: the ALPH chunk

inline int GradientPredictor(int a, int b, int c) {
  int g = a + b - c;
  return (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
}

// libwebp's WebPUnfilters, in place, row by row (prev null on the first row)
void UnfilterAlpha(int filter, uint8_t* plane, int width, int height) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    uint8_t* row = plane + static_cast<size_t>(y) * width;
    if (filter == 1 || (prev == nullptr && filter != 0)) {  // horizontal
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int i = 0; i < width; ++i) {
        row[i] = static_cast<uint8_t>(pred + row[i]);
        pred = row[i];
      }
    } else if (filter == 2) {  // vertical
      for (int i = 0; i < width; ++i) row[i] = static_cast<uint8_t>(prev[i] + row[i]);
    } else if (filter == 3) {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        left = static_cast<uint8_t>(row[i] + GradientPredictor(left, top, top_left));
        top_left = top;
        row[i] = left;
      }
    }
    prev = row;
  }
}

// The 8-bit path of the alpha's VP8L stream (colour indexing alone, no
// colour cache, red, blue and alpha codes of one symbol): green indices
// only, and the stream may end on its last pixel (libwebp's DecodeAlphaData).
bool DecodeAlphaData(VP8LDecoder* dec, uint8_t* data, int width, int height,
                     const Metadata* hdr) {
  LBitReader* br = &dec->br;
  int row = 0, col = 0, pos = 0;
  const int end = width * height;
  const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
  const int mask = hdr->huffman_mask;
  const HTreeGroup* group = pos < end ? GetHtreeGroupForPos(hdr, col, row) : nullptr;
  bool ok = true;
  while (!br->eos && pos < end) {
    if ((col & mask) == 0) group = GetHtreeGroupForPos(hdr, col, row);
    LFillBitWindow(br);
    int code = ReadSymbol(group->htrees[GREEN].data(), br);
    if (code < kNumLiteralCodes) {
      data[pos] = static_cast<uint8_t>(code);
      ++pos;
      ++col;
      if (col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < len_code_limit) {
      int length = GetCopyDistance(code - kNumLiteralCodes, br);
      int dist_symbol = ReadSymbol(group->htrees[DIST].data(), br);
      LFillBitWindow(br);
      int dist_code = GetCopyDistance(dist_symbol, br);
      int dist = PlaneCodeToDistance(width, dist_code);
      if (pos >= dist && end - pos >= length) {
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      } else {
        ok = false;
        break;
      }
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (pos < end && (col & mask)) group = GetHtreeGroupForPos(hdr, col, row);
    } else {
      ok = false;
      break;
    }
    br->eos = LIsEndOfStream(br);
  }
  br->eos = LIsEndOfStream(br);
  return ok && !(br->eos && pos < end);
}

int DecodeAlphaVp8l(const uint8_t* data, size_t size, int width, int height, uint8_t* alpha) {
  VP8LDecoder dec;
  LInit(&dec.br, data, size);
  Metadata hdr;
  int xsize = 0;
  if (!DecodeImageStream(width, height, true, &dec, nullptr, &hdr, &xsize)) {
    return kAlphaBitstream;
  }
  bool eight_bit = dec.next_transform == 1 && dec.transforms[0].type == 3 &&
                   hdr.color_cache_bits == 0;
  if (eight_bit) {
    for (const HTreeGroup& g : hdr.groups) {
      if (g.htrees[RED][0].bits > 0 || g.htrees[BLUE][0].bits > 0 ||
          g.htrees[ALPHA][0].bits > 0) {
        eight_bit = false;
      }
    }
  }
  if (eight_bit) {
    std::vector<uint8_t> idx(static_cast<size_t>(xsize) * height);
    if (!DecodeAlphaData(&dec, idx.data(), xsize, height, &hdr)) return kAlphaBitstream;
    const Transform& t = dec.transforms[0];
    std::vector<uint32_t> packed(idx.begin(), idx.end());
    for (uint32_t& v : packed) v <<= 8;
    std::vector<uint32_t> out(static_cast<size_t>(width) * height);
    InverseColorIndexing(t, packed.data(), out.data());
    for (size_t i = 0; i < out.size(); ++i) alpha[i] = static_cast<uint8_t>(out[i] >> 8);
    return kOk;
  }
  std::vector<uint32_t> px(static_cast<size_t>(xsize) * height);
  if (!DecodeImageData(&dec, px.data(), xsize, height, &hdr)) return kAlphaBitstream;
  px = ApplyInverseTransforms(&dec, std::move(px));
  for (size_t i = 0; i < px.size(); ++i) alpha[i] = static_cast<uint8_t>(px[i] >> 8);
  return kOk;
}

// The ALPH chunk's payload -> the alpha plane (width x height)
int DecodeAlpha(const uint8_t* data, size_t size, int width, int height, uint8_t* alpha) {
  if (size <= 1) return kBadAlphaHeader;
  int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3;
  int rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) return kBadAlphaHeader;
  size_t n = static_cast<size_t>(width) * height;
  if (method == 0) {
    if (size - 1 < n) return kAlphaTruncated;
    memcpy(alpha, data + 1, n);
  } else {
    int rc = DecodeAlphaVp8l(data + 1, size - 1, width, height, alpha);
    if (rc != kOk) return rc;
  }
  UnfilterAlpha(filter, alpha, width, height);
  return kOk;
}

// ===========================================================================
// VP8
// ===========================================================================

// RFC 6386's constants, as libwebp orders them: the intra 4x4 modes are
// DC, TM, VE, HE, RD, VR, LD, VL, HD, HU (libwebp's numbering, which
// kBModesProba and kYModesIntra4 follow)
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED };
// the DC predictors at the frame's edges
enum { DC_NOTOP = 10, DC_NOLEFT = 11, DC_NOTOPLEFT = 12 };

// kDcTable, kAcTable (RFC 6386 section 14.1)
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
     {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
     {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
     {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
     {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
     {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
     {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
     {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
     {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
     {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
     {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
     {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
     {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
     {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
     {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
     {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
     {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
     {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
     {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
     {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
     {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
     {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
     {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
     {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
     {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
     {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
     {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
     {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
     {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
     {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
     {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
     {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
     {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
     {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
     {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
     {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
     {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
     {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
     {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
     {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
     {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
     {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
     {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
     {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
     {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
     {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
     {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
     {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
     {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
     {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
     {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
     {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
     {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
     {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
     {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
     {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};

const uint8_t kBModesProba[10][10][9] = {
  {{231, 120, 48, 89, 115, 113, 120, 152, 112},
   {152, 179, 64, 126, 170, 118, 46, 70, 95},
   {175, 69, 143, 80, 85, 82, 72, 155, 103},
   {56, 58, 10, 171, 218, 189, 17, 13, 152},
   {114, 26, 17, 163, 44, 195, 21, 10, 173},
   {121, 24, 80, 195, 26, 62, 44, 64, 85},
   {144, 71, 10, 38, 171, 213, 144, 34, 26},
   {170, 46, 55, 19, 136, 160, 33, 206, 71},
   {63, 20, 8, 114, 114, 208, 12, 9, 226},
   {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {{134, 183, 89, 137, 98, 101, 106, 165, 148},
   {72, 187, 100, 130, 157, 111, 32, 75, 80},
   {66, 102, 167, 99, 74, 62, 40, 234, 128},
   {41, 53, 9, 178, 241, 141, 26, 8, 107},
   {74, 43, 26, 146, 73, 166, 49, 23, 157},
   {65, 38, 105, 160, 51, 52, 31, 115, 128},
   {104, 79, 12, 27, 217, 255, 87, 17, 7},
   {87, 68, 71, 44, 114, 51, 15, 186, 23},
   {47, 41, 14, 110, 182, 183, 21, 17, 194},
   {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {{88, 88, 147, 150, 42, 46, 45, 196, 205},
   {43, 97, 183, 117, 85, 38, 35, 179, 61},
   {39, 53, 200, 87, 26, 21, 43, 232, 171},
   {56, 34, 51, 104, 114, 102, 29, 93, 77},
   {39, 28, 85, 171, 58, 165, 90, 98, 64},
   {34, 22, 116, 206, 23, 34, 43, 166, 73},
   {107, 54, 32, 26, 51, 1, 81, 43, 31},
   {68, 25, 106, 22, 64, 171, 36, 225, 114},
   {34, 19, 21, 102, 132, 188, 16, 76, 124},
   {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {{193, 101, 35, 159, 215, 111, 89, 46, 111},
   {60, 148, 31, 172, 219, 228, 21, 18, 111},
   {112, 113, 77, 85, 179, 255, 38, 120, 114},
   {40, 42, 1, 196, 245, 209, 10, 25, 109},
   {88, 43, 29, 140, 166, 213, 37, 43, 154},
   {61, 63, 30, 155, 67, 45, 68, 1, 209},
   {100, 80, 8, 43, 154, 1, 51, 26, 71},
   {142, 78, 78, 16, 255, 128, 34, 197, 171},
   {41, 40, 5, 102, 211, 183, 4, 1, 221},
   {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {{138, 31, 36, 171, 27, 166, 38, 44, 229},
   {67, 87, 58, 169, 82, 115, 26, 59, 179},
   {63, 59, 90, 180, 59, 166, 93, 73, 154},
   {40, 40, 21, 116, 143, 209, 34, 39, 175},
   {47, 15, 16, 183, 34, 223, 49, 45, 183},
   {46, 17, 33, 183, 6, 98, 15, 32, 183},
   {57, 46, 22, 24, 128, 1, 54, 17, 37},
   {65, 32, 73, 115, 28, 128, 23, 128, 205},
   {40, 3, 9, 115, 51, 192, 18, 6, 223},
   {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {{104, 55, 44, 218, 9, 54, 53, 130, 226},
   {64, 90, 70, 205, 40, 41, 23, 26, 57},
   {54, 57, 112, 184, 5, 41, 38, 166, 213},
   {30, 34, 26, 133, 152, 116, 10, 32, 134},
   {39, 19, 53, 221, 26, 114, 32, 73, 255},
   {31, 9, 65, 234, 2, 15, 1, 118, 73},
   {75, 32, 12, 51, 192, 255, 160, 43, 51},
   {88, 31, 35, 67, 102, 85, 55, 186, 85},
   {56, 21, 23, 111, 59, 205, 45, 37, 192},
   {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {{125, 98, 42, 88, 104, 85, 117, 175, 82},
   {95, 84, 53, 89, 128, 100, 113, 101, 45},
   {75, 79, 123, 47, 51, 128, 81, 171, 1},
   {57, 17, 5, 71, 102, 57, 53, 41, 49},
   {38, 33, 13, 121, 57, 73, 26, 1, 85},
   {41, 10, 67, 138, 77, 110, 90, 47, 114},
   {115, 21, 2, 10, 102, 255, 166, 23, 6},
   {101, 29, 16, 10, 85, 128, 101, 196, 26},
   {57, 18, 10, 102, 102, 213, 34, 20, 43},
   {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {{102, 61, 71, 37, 34, 53, 31, 243, 192},
   {69, 60, 71, 38, 73, 119, 28, 222, 37},
   {68, 45, 128, 34, 1, 47, 11, 245, 171},
   {62, 17, 19, 70, 146, 85, 55, 62, 70},
   {37, 43, 37, 154, 100, 163, 85, 160, 1},
   {63, 9, 92, 136, 28, 64, 32, 201, 85},
   {75, 15, 9, 9, 64, 255, 184, 119, 16},
   {86, 6, 28, 5, 64, 255, 25, 248, 1},
   {56, 8, 17, 132, 137, 255, 55, 116, 128},
   {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {{164, 50, 31, 137, 154, 133, 25, 35, 218},
   {51, 103, 44, 131, 131, 123, 31, 6, 158},
   {86, 40, 64, 135, 148, 224, 45, 183, 128},
   {22, 26, 17, 131, 240, 154, 14, 1, 209},
   {45, 16, 21, 91, 64, 222, 7, 1, 197},
   {56, 21, 39, 155, 60, 138, 23, 102, 213},
   {83, 12, 13, 54, 192, 255, 68, 47, 28},
   {85, 26, 85, 85, 128, 128, 32, 146, 171},
   {18, 11, 7, 63, 144, 171, 4, 4, 246},
   {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {{190, 80, 35, 99, 180, 80, 126, 54, 45},
   {85, 126, 47, 87, 176, 51, 41, 20, 32},
   {101, 75, 128, 139, 118, 146, 116, 128, 85},
   {56, 41, 15, 176, 236, 85, 37, 9, 62},
   {71, 30, 17, 119, 118, 255, 17, 18, 138},
   {101, 38, 60, 138, 55, 70, 43, 26, 142},
   {146, 36, 19, 30, 171, 255, 97, 27, 20},
   {138, 45, 61, 62, 219, 1, 81, 188, 64},
   {32, 41, 20, 117, 151, 142, 20, 21, 163},
   {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};


const int8_t kYModesIntra4[18] = {-B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6,
                                  -B_HE_PRED, 5, -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7,
                                  -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// ---- the boolean decoder, as libwebp's on a 64-bit machine (BITS = 56): 7
// bytes at a time while 8 remain, then one at a time. A valid stream reads
// the same bits however it is loaded; a corrupt one (whose value exceeds its
// range) decodes to what libwebp makes of it only with libwebp's loads, its
// 32-bit window and its branch-free sign read.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* buf_end = nullptr;
  const uint8_t* buf_max = nullptr;  // bulk loads while buf < buf_max
  uint64_t value = 0;
  uint32_t range = 254;  // range - 1
  int bits = -8;         // bits of `value` below the current 8-bit window
  bool eof = false;
};

void BrLoadFinalBytes(BoolReader* br) {
  if (br->buf < br->buf_end) {
    br->bits += 8;
    br->value = static_cast<uint64_t>(*br->buf++) | (br->value << 8);
  } else if (!br->eof) {
    br->value <<= 8;
    br->bits += 8;
    br->eof = true;
  } else {
    br->bits = 0;  // past the end: the partition is refused
  }
}

inline void BrLoadNewBytes(BoolReader* br) {
  if (br->buf < br->buf_max) {
    uint64_t bits = 0;
    for (int i = 0; i < 7; ++i) bits = (bits << 8) | br->buf[i];
    br->buf += 7;
    br->value = bits | (br->value << 56);
    br->bits += 56;
  } else {
    BrLoadFinalBytes(br);
  }
}

void BrInit(BoolReader* br, const uint8_t* start, size_t size) {
  br->range = 255 - 1;
  br->value = 0;
  br->bits = -8;
  br->eof = false;
  br->buf = start;
  br->buf_end = start + size;
  br->buf_max = size >= 8 ? start + size - 8 + 1 : start;
  BrLoadNewBytes(br);
}

inline int BitsLog2Floor(uint32_t n) { return 31 ^ __builtin_clz(n); }

inline int GetBit(BoolReader* br, int prob) {
  uint32_t range = br->range;
  if (br->bits < 0) BrLoadNewBytes(br);
  const int pos = br->bits;
  const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
  const uint32_t value = static_cast<uint32_t>(br->value >> pos);
  const int bit = value > split;
  if (bit) {
    range -= split;
    br->value -= static_cast<uint64_t>(split + 1) << pos;
  } else {
    range = split + 1;
  }
  const int shift = 7 ^ BitsLog2Floor(range);
  range <<= shift;
  br->bits -= shift;
  br->range = range - 1;
  return bit;
}

// VP8GetSigned: a bit of probability 1/2 giving -v or v, read as libwebp
// reads a coefficient's sign
inline int GetSigned(BoolReader* br, int v) {
  if (br->bits < 0) BrLoadNewBytes(br);
  const int pos = br->bits;
  const uint32_t split = br->range >> 1;
  const uint32_t value = static_cast<uint32_t>(br->value >> pos);
  const int32_t mask = static_cast<int32_t>(split - value) >> 31;  // -1 or 0
  br->bits -= 1;
  br->range += static_cast<uint32_t>(mask);
  br->range |= 1;
  br->value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
  return (v ^ mask) - mask;
}

inline uint32_t GetValue(BoolReader* br, int bits) {
  uint32_t v = 0;
  while (bits-- > 0) v |= static_cast<uint32_t>(GetBit(br, 0x80)) << bits;
  return v;
}

inline int32_t GetSignedValue(BoolReader* br, int bits) {
  const int value = static_cast<int>(GetValue(br, bits));
  return GetBit(br, 0x80) ? -value : value;
}

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
};

struct VP8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int8_t quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segment_probs[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  // partitions
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;
  QuantMatrix dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
};

inline int Clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

bool ParseSegmentHeader(VP8Decoder* dec) {
  BoolReader* br = &dec->br;
  dec->use_segment = GetBit(br, 0x80);
  if (dec->use_segment) {
    dec->update_map = GetBit(br, 0x80);
    if (GetBit(br, 0x80)) {  // update data
      dec->absolute_delta = GetBit(br, 0x80);
      for (int s = 0; s < 4; ++s) {
        dec->quantizer[s] = static_cast<int8_t>(GetBit(br, 0x80) ? GetSignedValue(br, 7) : 0);
      }
      for (int s = 0; s < 4; ++s) {
        dec->filter_strength[s] =
            static_cast<int8_t>(GetBit(br, 0x80) ? GetSignedValue(br, 6) : 0);
      }
    }
    if (dec->update_map) {
      for (int s = 0; s < 3; ++s) {
        dec->segment_probs[s] = static_cast<uint8_t>(GetBit(br, 0x80) ? GetValue(br, 8) : 255u);
      }
    }
  } else {
    dec->update_map = false;
  }
  return !br->eof;
}

bool ParseFilterHeader(VP8Decoder* dec) {
  BoolReader* br = &dec->br;
  dec->simple = GetBit(br, 0x80);
  dec->level = static_cast<int>(GetValue(br, 6));
  dec->sharpness = static_cast<int>(GetValue(br, 3));
  dec->use_lf_delta = GetBit(br, 0x80);
  if (dec->use_lf_delta) {
    if (GetBit(br, 0x80)) {  // update the deltas
      for (int i = 0; i < 4; ++i) {
        if (GetBit(br, 0x80)) dec->ref_lf_delta[i] = GetSignedValue(br, 6);
      }
      for (int i = 0; i < 4; ++i) {
        if (GetBit(br, 0x80)) dec->mode_lf_delta[i] = GetSignedValue(br, 6);
      }
    }
  }
  dec->filter_type = dec->level == 0 ? 0 : dec->simple ? 1 : 2;
  return !br->eof;
}

// the token partitions after partition 0: sizes (3 bytes each, but the
// last's) clipped to the data, the last taking the rest, which must not be empty
bool ParsePartitions(VP8Decoder* dec, const uint8_t* buf, size_t size) {
  const uint8_t* sz = buf;
  const uint8_t* buf_end = buf + size;
  dec->num_parts_minus_one = (1 << GetValue(&dec->br, 2)) - 1;
  const size_t last_part = dec->num_parts_minus_one;
  if (size < 3 * last_part) return false;
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    BrInit(&dec->parts[p], part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  BrInit(&dec->parts[last_part], part_start, size_left);
  return part_start < buf_end;
}

void ParseQuant(VP8Decoder* dec) {
  BoolReader* br = &dec->br;
  const int base_q0 = static_cast<int>(GetValue(br, 7));
  const int dqy1_dc = GetBit(br, 0x80) ? GetSignedValue(br, 4) : 0;
  const int dqy2_dc = GetBit(br, 0x80) ? GetSignedValue(br, 4) : 0;
  const int dqy2_ac = GetBit(br, 0x80) ? GetSignedValue(br, 4) : 0;
  const int dquv_dc = GetBit(br, 0x80) ? GetSignedValue(br, 4) : 0;
  const int dquv_ac = GetBit(br, 0x80) ? GetSignedValue(br, 4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (dec->use_segment) {
      q = dec->quantizer[i];
      if (!dec->absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dec->dqm[i] = dec->dqm[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix* m = &dec->dqm[i];
    m->y1[0] = kDcTable[Clip(q + dqy1_dc, 127)];
    m->y1[1] = kAcTable[Clip(q + 0, 127)];
    m->y2[0] = kDcTable[Clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100, as (x * 101581) >> 16, at least 8
    m->y2[1] = (kAcTable[Clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m->y2[1] < 8) m->y2[1] = 8;
    m->uv[0] = kDcTable[Clip(q + dquv_dc, 117)];
    m->uv[1] = kAcTable[Clip(q + dquv_ac, 127)];
  }
}

void ParseProba(VP8Decoder* dec) {
  BoolReader* br = &dec->br;
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b) {
      for (int c = 0; c < 3; ++c) {
        for (int p = 0; p < 11; ++p) {
          dec->proba[t][b][c][p] = static_cast<uint8_t>(
              GetBit(br, kCoeffsUpdateProba[t][b][c][p]) ? GetValue(br, 8)
                                                         : kCoeffsProba0[t][b][c][p]);
        }
      }
    }
  }
  dec->use_skip_proba = GetBit(br, 0x80);
  if (dec->use_skip_proba) dec->skip_p = static_cast<int>(GetValue(br, 8));
}

void PrecomputeFilterStrengths(VP8Decoder* dec) {
  if (dec->filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (dec->use_segment) {
      base_level = dec->filter_strength[s];
      if (!dec->absolute_delta) base_level += dec->level;
    } else {
      base_level = dec->level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo* info = &dec->fstrengths[s][i4x4];
      int level = base_level;
      if (dec->use_lf_delta) {
        level += dec->ref_lf_delta[0];
        if (i4x4) level += dec->mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (dec->sharpness > 0) {
          ilevel >>= dec->sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - dec->sharpness) ilevel = 9 - dec->sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info->ilevel = static_cast<uint8_t>(ilevel);
        info->limit = static_cast<uint8_t>(2 * level + ilevel);
        info->hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info->limit = 0;
      }
      info->inner = static_cast<uint8_t>(i4x4);
    }
  }
}

// ---- modes and coefficients

void ParseIntraMode(BoolReader* br, const VP8Decoder* dec, uint8_t* top, uint8_t* left,
                    MBData* block) {
  if (dec->update_map) {
    block->segment = !GetBit(br, dec->segment_probs[0])
                         ? static_cast<uint8_t>(GetBit(br, dec->segment_probs[1]))
                         : static_cast<uint8_t>(GetBit(br, dec->segment_probs[2]) + 2);
  } else {
    block->segment = 0;
  }
  block->skip = dec->use_skip_proba ? static_cast<uint8_t>(GetBit(br, dec->skip_p)) : 0;
  block->is_i4x4 = !GetBit(br, 145);
  if (!block->is_i4x4) {
    const int ymode = GetBit(br, 156) ? (GetBit(br, 128) ? TM_PRED : H_PRED)
                                      : (GetBit(br, 163) ? V_PRED : DC_PRED);
    block->imodes[0] = static_cast<uint8_t>(ymode);
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = block->imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[GetBit(br, prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + GetBit(br, prob[i])];
        ymode = -i;
        top[x] = static_cast<uint8_t>(ymode);
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  block->uvmode = !GetBit(br, 142)   ? DC_PRED
                  : !GetBit(br, 114) ? V_PRED
                  : GetBit(br, 183)  ? TM_PRED
                                     : H_PRED;
}

int GetLargeValue(BoolReader* br, const uint8_t* p) {
  int v;
  if (!GetBit(br, p[3])) {
    if (!GetBit(br, p[4])) {
      v = 2;
    } else {
      v = 3 + GetBit(br, p[5]);
    }
  } else {
    if (!GetBit(br, p[6])) {
      if (!GetBit(br, p[7])) {
        v = 5 + GetBit(br, 159);
      } else {
        v = 7 + 2 * GetBit(br, 165);
        v += GetBit(br, 145);
      }
    } else {
      const int bit1 = GetBit(br, p[8]);
      const int bit0 = GetBit(br, p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + GetBit(br, *tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// The coefficients of one 4x4 block from position n on, dequantized, in
// raster order; returns the position after the last one coded (its "end of
// block"). Stored as int16, wrapping as libwebp's int16 stores do.
int GetCoeffs(BoolReader* br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
              int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!GetBit(br, p[0])) return n;  // end of block
    while (!GetBit(br, p[1])) {       // a zero coefficient
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!GetBit(br, p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = GetLargeValue(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = static_cast<int16_t>(GetSigned(br, v) * dq[n > 0]);
  }
  return 16;
}

void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

inline uint32_t NzCodeBits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// the non-zero contexts: of the macroblock above (per column) and to the left (per row)
struct NzContext {
  uint8_t y[4] = {0, 0, 0, 0}, u[2] = {0, 0}, v[2] = {0, 0}, dc = 0;
};

// Returns whether every coefficient is zero.
bool ParseResiduals(const VP8Decoder* dec, BoolReader* br, NzContext* top, NzContext* left,
                    MBData* block) {
  const QuantMatrix* q = &dec->dqm[block->segment];
  int16_t* dst = block->coeffs;
  memset(dst, 0, 384 * sizeof(*dst));
  int first;
  const uint8_t (*ac_proba)[3][11];
  if (!block->is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top->dc + left->dc;
    const int nz = GetCoeffs(br, dec->proba[1], ctx, q->y2, 0, dc);
    top->dc = left->dc = nz > 0;
    if (nz > 1) {
      TransformWHT(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_proba = dec->proba[0];
  } else {
    first = 0;
    ac_proba = dec->proba[3];
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  for (int y = 0; y < 4; ++y) {
    int l = left->y[y];
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + top->y[x];
      const int nz = GetCoeffs(br, ac_proba, ctx, q->y1, first, dst);
      l = nz > first;
      top->y[x] = static_cast<uint8_t>(l);
      nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    left->y[y] = static_cast<uint8_t>(l);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  for (int ch = 0; ch < 2; ++ch) {
    uint8_t* tnz = ch == 0 ? top->u : top->v;
    uint8_t* lnz = ch == 0 ? left->u : left->v;
    uint32_t nz_coeffs = 0;
    for (int y = 0; y < 2; ++y) {
      int l = lnz[y];
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + tnz[x];
        const int nz = GetCoeffs(br, dec->proba[2], ctx, q->uv, 0, dst);
        l = nz > 0;
        tnz[x] = static_cast<uint8_t>(l);
        nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      lnz[y] = static_cast<uint8_t>(l);
    }
    non_zero_uv |= nz_coeffs << (8 * ch);
  }
  block->non_zero_y = non_zero_y;
  block->non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// ---- reconstruction, in a work buffer laid out as libwebp's: BPS bytes a
// row, the luma at Y_OFF with a row above and a column to its left, 4
// columns to its right (the top-right samples), the chroma below it
constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t Clip8b(int v) { return (!(v & ~0xff)) ? v : (v < 0) ? 0 : 255; }

inline int Mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int Mul2(int a) { return (a * 35468) >> 16; }

void TransformOne(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = Mul2(in[4]) - Mul1(in[12]);
    const int d = Mul1(in[4]) + Mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = Mul2(tmp[4]) - Mul1(tmp[12]);
    const int d = Mul1(tmp[4]) + Mul2(tmp[12]);
    dst[0] = Clip8b(dst[0] + ((a + d) >> 3));
    dst[1] = Clip8b(dst[1] + ((b + c) >> 3));
    dst[2] = Clip8b(dst[2] + ((b - c) >> 3));
    dst[3] = Clip8b(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

// TransformOne as libwebp's SSE2 Transform computes it, in 16-bit lanes: every
// sum wraps at 16 bits and each product is a 16-bit multiply-high (x * K2 >> 16
// as mulhi(x, 35468 - 65536) + x). For coefficients of a valid stream nothing
// wraps and this is TransformOne; a corrupt stream decodes as libwebp (on x86)
// decodes it.
inline int16_t Wrap16(int v) { return static_cast<int16_t>(v); }
inline int16_t MulHi16(int16_t a, int k) {
  return static_cast<int16_t>((static_cast<int32_t>(a) * k) >> 16);
}
inline int16_t Mul1W(int16_t a) { return Wrap16(MulHi16(a, 20091) + a); }
inline int16_t Mul2W(int16_t a) { return Wrap16(MulHi16(a, 35468 - 65536) + a); }

void TransformOneWrapped(const int16_t* in, uint8_t* dst) {
  int16_t C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int16_t a = Wrap16(in[0] + in[8]);
    const int16_t b = Wrap16(in[0] - in[8]);
    const int16_t c = Wrap16(Mul2W(in[4]) - Mul1W(in[12]));
    const int16_t d = Wrap16(Mul1W(in[4]) + Mul2W(in[12]));
    tmp[0] = Wrap16(a + d);
    tmp[1] = Wrap16(b + c);
    tmp[2] = Wrap16(b - c);
    tmp[3] = Wrap16(a - d);
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int16_t dc = Wrap16(tmp[0] + 4);
    const int16_t a = Wrap16(dc + tmp[8]);
    const int16_t b = Wrap16(dc - tmp[8]);
    const int16_t c = Wrap16(Mul2W(tmp[4]) - Mul1W(tmp[12]));
    const int16_t d = Wrap16(Mul1W(tmp[4]) + Mul2W(tmp[12]));
    dst[0] = Clip8b(dst[0] + (Wrap16(a + d) >> 3));
    dst[1] = Clip8b(dst[1] + (Wrap16(b + c) >> 3));
    dst[2] = Clip8b(dst[2] + (Wrap16(b - c) >> 3));
    dst[3] = Clip8b(dst[3] + (Wrap16(a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

// the DC-only transform, bit-equal to TransformOne on a block whose only
// non-zero coefficient is the DC
void TransformDC(const int16_t* in, uint8_t* dst) {
  const int DC = in[0] + 4;
  for (int j = 0; j < 4; ++j) {
    for (int i = 0; i < 4; ++i) dst[i + j * BPS] = Clip8b(dst[i + j * BPS] + (DC >> 3));
  }
}

// `bits`: the block's 2-bit code (0 nothing, 1 DC only, 2 the first three
// coefficients at most, 3 more), each with the transform libwebp runs for it
// on x86: the DC-only and the three-coefficient ones in C's int arithmetic
// (bit-equal to TransformOne there), the full one in SSE2's 16-bit lanes
inline void DoTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: TransformOneWrapped(src, dst); break;
    case 2: TransformOne(src, dst); break;
    case 1: TransformDC(src, dst); break;
    default: break;
  }
}

void DoUVTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {
    for (int b = 0; b < 4; ++b) {
      uint8_t* d = dst + (b & 1) * 4 + (b >> 1) * 4 * BPS;
      if (bits & 0xaa) {  // all four through the full transform
        TransformOneWrapped(src + b * 16, d);
      } else if (src[b * 16]) {
        TransformDC(src + b * 16, d);
      }
    }
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) (static_cast<uint8_t>(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = Clip8b(top[x] + l - tl);
    dst += BPS;
  }
}

void Fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void PredLuma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      Fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED: TrueMotion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, AVG3(A, B, C), 4);
      memset(dst + 1 * BPS, AVG3(B, C, D), 4);
      memset(dst + 2 * BPS, AVG3(C, D, E), 4);
      memset(dst + 3 * BPS, AVG3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
    default: {  // B_HU_PRED
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    }
  }
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) prediction
void PredBlock(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      Fill(dst, dc >> (shift + 1), size);
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      Fill(dst, dc >> shift, size);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      Fill(dst, dc >> shift, size);
      break;
    }
    case DC_NOTOPLEFT: Fill(dst, 0x80, size); break;
    case TM_PRED: TrueMotion(dst, size); break;
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    default:  // H_PRED
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

inline int CheckMode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : static_cast<int>(DC_PRED);
  }
  return mode;
}

// the unfiltered planes the macroblocks are reconstructed into (a whole
// number of macroblocks each way)
struct Planes {
  int y_stride, uv_stride;
  std::vector<uint8_t> y, u, v;
};

void ReconstructMB(const MBData* block, int mb_x, int mb_y, int mb_w, Planes* pl,
                   uint8_t* yuv_b) {
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  const int ys = pl->y_stride, uvs = pl->uv_stride;
  const uint8_t* y_src = pl->y.data() + static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16;
  const uint8_t* u_src = pl->u.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
  const uint8_t* v_src = pl->v.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
  // the left column: 129 at the frame's left edge
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mb_x > 0 ? y_src[j * ys - 1] : 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = mb_x > 0 ? u_src[j * uvs - 1] : 129;
    v_dst[j * BPS - 1] = mb_x > 0 ? v_src[j * uvs - 1] : 129;
  }
  // the row above (with the top-left and top-right): 127 along the top edge,
  // the top-left 129 at the left edge below it
  if (mb_y == 0) {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  } else {
    y_dst[-1 - BPS] = mb_x > 0 ? y_src[-ys - 1] : 129;
    u_dst[-1 - BPS] = mb_x > 0 ? u_src[-uvs - 1] : 129;
    v_dst[-1 - BPS] = mb_x > 0 ? v_src[-uvs - 1] : 129;
    memcpy(y_dst - BPS, y_src - ys, 16);
    memcpy(u_dst - BPS, u_src - uvs, 8);
    memcpy(v_dst - BPS, v_src - uvs, 8);
  }
  const int16_t* coeffs = block->coeffs;
  uint32_t bits = block->non_zero_y;
  if (block->is_i4x4) {
    uint8_t* top_right = y_dst - BPS + 16;
    if (mb_y > 0) {
      if (mb_x >= mb_w - 1) {  // the rightmost: its own top row's last sample
        memset(top_right, y_src[-ys + 15], 4);
      } else {
        memcpy(top_right, y_src - ys + 16, 4);
      }
    }
    // the blocks of the right column use the macroblock's top-right samples
    for (int k = 1; k < 4; ++k) memcpy(top_right + k * 4 * BPS, top_right, 4);
    for (int n = 0; n < 16; ++n, bits <<= 2) {
      uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
      PredLuma4(block->imodes[n], dst);
      DoTransform(bits, coeffs + n * 16, dst);
    }
  } else {
    PredBlock(CheckMode(mb_x, mb_y, block->imodes[0]), y_dst, 16);
    if (bits != 0) {
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        DoTransform(bits, coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
    }
  }
  const int uvmode = CheckMode(mb_x, mb_y, block->uvmode);
  PredBlock(uvmode, u_dst, 8);
  PredBlock(uvmode, v_dst, 8);
  DoUVTransform(block->non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
  DoUVTransform(block->non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
  uint8_t* y_out = pl->y.data() + static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16;
  uint8_t* u_out = pl->u.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
  uint8_t* v_out = pl->v.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
  for (int j = 0; j < 16; ++j) memcpy(y_out + j * ys, y_dst + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    memcpy(u_out + j * uvs, u_dst + j * BPS, 8);
    memcpy(v_out + j * uvs, v_dst + j * BPS, 8);
  }
}

// ---- the loop filters (libwebp's src/dsp/dec.c)

inline int SClip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int SClip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]
inline uint8_t Clip1(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }    // [-255, 511]

inline void DoFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + SClip1(p1 - q1);
  const int a1 = SClip2((a + 4) >> 3);
  const int a2 = SClip2((a + 3) >> 3);
  p[-step] = Clip1(p0 + a2);
  p[0] = Clip1(q0 - a1);
}

inline void DoFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = SClip2((a + 4) >> 3);
  const int a2 = SClip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = Clip1(p1 + a3);
  p[-step] = Clip1(p0 + a2);
  p[0] = Clip1(q0 - a1);
  p[step] = Clip1(q1 - a3);
}

inline void DoFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = SClip1(3 * (q0 - p0) + SClip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = Clip1(p2 + a3);
  p[-2 * step] = Clip1(p1 + a2);
  p[-step] = Clip1(p0 + a1);
  p[0] = Clip1(q0 - a1);
  p[step] = Clip1(q1 - a2);
  p[2 * step] = Clip1(q2 - a3);
}

inline int Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (std::abs(p1 - p0) > thresh) || (std::abs(q1 - q0) > thresh);
}

inline int NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}

inline int NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `hstride` across the edge, `vstride` along it
void SimpleFilter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (NeedsFilter(p + i * vstride, hstride, thresh2)) DoFilter2(p + i * vstride, hstride);
  }
}

void FilterLoop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                  int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, thresh2, ithresh)) {
      if (Hev(p, hstride, hev_thresh)) {
        DoFilter2(p, hstride);
      } else {
        DoFilter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void FilterLoop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                  int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, thresh2, ithresh)) {
      if (Hev(p, hstride, hev_thresh)) {
        DoFilter2(p, hstride);
      } else {
        DoFilter4(p, hstride);
      }
    }
    p += vstride;
  }
}

// libwebp's DoFilter for one macroblock: left edge, inner vertical edges,
// top edge, inner horizontal edges
void FilterMB(const VP8Decoder* dec, const FInfo& f, int mb_x, int mb_y, Planes* pl) {
  const int limit = f.limit;
  if (limit == 0) return;
  const int ys = pl->y_stride, uvs = pl->uv_stride;
  uint8_t* y_dst = pl->y.data() + static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16;
  if (dec->filter_type == 1) {  // simple: luma only
    if (mb_x > 0) SimpleFilter(y_dst, 1, ys, limit + 4);
    if (f.inner) {
      for (int k = 1; k < 4; ++k) SimpleFilter(y_dst + 4 * k, 1, ys, limit);
    }
    if (mb_y > 0) SimpleFilter(y_dst, ys, 1, limit + 4);
    if (f.inner) {
      for (int k = 1; k < 4; ++k) SimpleFilter(y_dst + 4 * k * ys, ys, 1, limit);
    }
    return;
  }
  uint8_t* u_dst = pl->u.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
  uint8_t* v_dst = pl->v.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
  const int ilevel = f.ilevel, hev = f.hev_thresh;
  if (mb_x > 0) {
    FilterLoop26(y_dst, 1, ys, 16, limit + 4, ilevel, hev);
    FilterLoop26(u_dst, 1, uvs, 8, limit + 4, ilevel, hev);
    FilterLoop26(v_dst, 1, uvs, 8, limit + 4, ilevel, hev);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) FilterLoop24(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev);
    FilterLoop24(u_dst + 4, 1, uvs, 8, limit, ilevel, hev);
    FilterLoop24(v_dst + 4, 1, uvs, 8, limit, ilevel, hev);
  }
  if (mb_y > 0) {
    FilterLoop26(y_dst, ys, 1, 16, limit + 4, ilevel, hev);
    FilterLoop26(u_dst, uvs, 1, 8, limit + 4, ilevel, hev);
    FilterLoop26(v_dst, uvs, 1, 8, limit + 4, ilevel, hev);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) FilterLoop24(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev);
    FilterLoop24(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev);
    FilterLoop24(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev);
  }
}

// ---- YUV 4:2:0 -> RGBA: libwebp's fancy upsampler and VP8YuvToRgb

inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline int YuvClip8(int v) { return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255; }

inline void YuvToRgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) + MultHi(v, 26149) - 14234));
  rgba[1] = static_cast<uint8_t>(
      YuvClip8(MultHi(y, 19077) - MultHi(u, 6419) - MultHi(v, 13320) + 8708));
  rgba[2] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) + MultHi(u, 33050) - 17685));
}

// UPSAMPLE_FUNC of upsampling.c: two output rows (bottom may be null) from
// the chroma rows above (top_*) and below (cur_*) them; u and v packed in
// one word, as libwebp computes them
void UpsampleLinePair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                      const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                      uint8_t* top_dst, uint8_t* bottom_dst, int len) {
#define LOAD_UV(u, v) ((u) | ((v) << 16))
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
  uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    YuvToRgba(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    YuvToRgba(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
    const uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      YuvToRgba(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 4);
      YuvToRgba(top_y[2 * x - 0], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x - 0) * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      YuvToRgba(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 4);
      YuvToRgba(bottom_y[2 * x + 0], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x + 0) * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      YuvToRgba(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      YuvToRgba(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 4);
    }
  }
#undef LOAD_UV
}

// libwebp's EmitFancyRGB over the whole frame: row 0 alone (its chroma row
// mirrored), then pairs of rows between chroma rows, then the last row of
// an even height alone
void EmitFancyRgba(const Planes& pl, int width, int height, uint8_t* rgba) {
  const int stride = width * 4;
  const uint8_t* cur_y = pl.y.data();
  const uint8_t* cur_u = pl.u.data();
  const uint8_t* cur_v = pl.v.data();
  uint8_t* dst = rgba;
  UpsampleLinePair(cur_y, nullptr, cur_u, cur_v, cur_u, cur_v, dst, nullptr, width);
  int y = 0;
  for (; y + 2 < height; y += 2) {
    const uint8_t* top_u = cur_u;
    const uint8_t* top_v = cur_v;
    cur_u += pl.uv_stride;
    cur_v += pl.uv_stride;
    dst += 2 * stride;
    cur_y += 2 * pl.y_stride;
    UpsampleLinePair(cur_y - pl.y_stride, cur_y, top_u, top_v, cur_u, cur_v, dst - stride, dst,
                     width);
  }
  cur_y += pl.y_stride;
  if (!(height & 1)) {
    UpsampleLinePair(cur_y, nullptr, cur_u, cur_v, cur_u, cur_v, dst + stride, nullptr, width);
  }
}

// A VP8 key frame (its chunk's payload) -> RGBA, alpha 255.
int DecodeVp8(const uint8_t* data, size_t size, int width, int height, uint8_t* rgba) {
  if (size < 10) return kBadVp8Header;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (!key_frame || profile > 3 || !show) return kBadVp8Header;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kBadVp8Header;
  const int w = ((data[7] << 8) | data[6]) & 0x3fff;
  const int h = ((data[9] << 8) | data[8]) & 0x3fff;
  if (w != width || h != height) return kSizeMismatch;
  const uint8_t* buf = data + 10;
  size_t buf_size = size - 10;
  VP8Decoder dec;
  dec.width = w;
  dec.height = h;
  dec.mb_w = (w + 15) >> 4;
  dec.mb_h = (h + 15) >> 4;
  if (partition_length > buf_size) return kVp8Partition0;
  BrInit(&dec.br, buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  GetBit(&dec.br, 0x80);  // colour space
  GetBit(&dec.br, 0x80);  // clamping type
  if (!ParseSegmentHeader(&dec) || !ParseFilterHeader(&dec)) return kVp8HeaderEof;
  if (!ParsePartitions(&dec, buf, buf_size)) return kVp8Partitions;
  ParseQuant(&dec);
  GetBit(&dec.br, 0x80);  // update_proba: ignored in a key frame
  ParseProba(&dec);
  PrecomputeFilterStrengths(&dec);

  const int mb_w = dec.mb_w, mb_h = dec.mb_h;
  Planes pl;
  pl.y_stride = mb_w * 16;
  pl.uv_stride = mb_w * 8;
  pl.y.assign(static_cast<size_t>(pl.y_stride) * mb_h * 16, 0);
  pl.u.assign(static_cast<size_t>(pl.uv_stride) * mb_h * 8, 0);
  pl.v.assign(static_cast<size_t>(pl.uv_stride) * mb_h * 8, 0);
  std::vector<FInfo> finfo(dec.filter_type > 0 ? static_cast<size_t>(mb_w) * mb_h : 0);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  std::vector<NzContext> nz_top(mb_w);
  std::vector<MBData> row_data(mb_w);
  std::vector<uint8_t> yuv_b(YUV_SIZE + BPS, 0);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint8_t intra_l[4];
    memset(intra_l, B_DC_PRED, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      ParseIntraMode(&dec.br, &dec, &intra_t[4 * mb_x], intra_l, &row_data[mb_x]);
    }
    if (dec.br.eof) return kVp8Premature0;
    BoolReader* token_br = &dec.parts[mb_y & dec.num_parts_minus_one];
    NzContext nz_left;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData* block = &row_data[mb_x];
      NzContext* top = &nz_top[mb_x];
      bool skip = dec.use_skip_proba ? block->skip : false;
      if (!skip) {
        skip = ParseResiduals(&dec, token_br, top, &nz_left, block);
      } else {
        const uint8_t dc_top = top->dc, dc_left = nz_left.dc;
        *top = NzContext();
        nz_left = NzContext();
        if (block->is_i4x4) {  // an i4x4 macroblock keeps the Y2 contexts
          top->dc = dc_top;
          nz_left.dc = dc_left;
        }
        block->non_zero_y = 0;
        block->non_zero_uv = 0;
      }
      if (dec.filter_type > 0) {
        FInfo f = dec.fstrengths[block->segment][block->is_i4x4];
        f.inner |= !skip;
        finfo[static_cast<size_t>(mb_y) * mb_w + mb_x] = f;
      }
      if (token_br->eof) return kVp8PrematureTokens;
      ReconstructMB(block, mb_x, mb_y, mb_w, &pl, yuv_b.data());
    }
  }
  if (dec.filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        FilterMB(&dec, finfo[static_cast<size_t>(mb_y) * mb_w + mb_x], mb_x, mb_y, &pl);
      }
    }
  }
  EmitFancyRgba(pl, w, h, rgba);
  for (size_t i = 0, n = static_cast<size_t>(w) * h; i < n; ++i) rgba[4 * i + 3] = 255;
  return kOk;
}

}  // namespace

extern "C" {

// Decodes one frame's bitstream into `rgba` (width x height x 4, allocated
// by the caller from the header the caller parsed): `data` is the VP8L
// chunk's payload (`lossless` 1) or the VP8 chunk's (0), padding included;
// `alpha`, where not null, the ALPH chunk's payload of a lossy frame.
// Returns 0, or one of the Status codes; never reads outside the buffers.
int vtc_webp_decode(const uint8_t* data, size_t size, int lossless, const uint8_t* alpha,
                    size_t alpha_size, int width, int height, uint8_t* rgba) {
  try {
    if (lossless) {
      std::vector<uint32_t> argb;
      int rc = DecodeVp8l(data, size, width, height, &argb);
      if (rc != kOk) return rc;
      for (size_t i = 0; i < argb.size(); ++i) {
        const uint32_t p = argb[i];
        rgba[4 * i + 0] = static_cast<uint8_t>(p >> 16);
        rgba[4 * i + 1] = static_cast<uint8_t>(p >> 8);
        rgba[4 * i + 2] = static_cast<uint8_t>(p);
        rgba[4 * i + 3] = static_cast<uint8_t>(p >> 24);
      }
      return kOk;
    }
    int rc = DecodeVp8(data, size, width, height, rgba);
    if (rc != kOk || alpha == nullptr) return rc;
    std::vector<uint8_t> plane(static_cast<size_t>(width) * height);
    rc = DecodeAlpha(alpha, alpha_size, width, height, plane.data());
    if (rc != kOk) return rc;
    for (size_t i = 0; i < plane.size(); ++i) rgba[4 * i + 3] = plane[i];
    return kOk;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"

#ifdef VTC_WEBP_MAIN
// A standalone decoder of a file of cases, for a build with sanitizers:
// each case is lossless (1 byte), width, height, data size, alpha size
// (4 bytes each, little-endian; alpha size 0xffffffff: no alpha), the data,
// the alpha. Prints each case's return code on a line of its own.
int main(int argc, char** argv) {
  if (argc != 2) {
    fprintf(stderr, "usage: %s CASES\n", argv[0]);
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  std::vector<uint8_t> all;
  uint8_t chunk[65536];
  size_t n;
  while ((n = fread(chunk, 1, sizeof(chunk), f)) > 0) all.insert(all.end(), chunk, chunk + n);
  fclose(f);
  auto le32 = [&](size_t at) {
    return static_cast<uint32_t>(all[at] | all[at + 1] << 8 | all[at + 2] << 16 |
                                 static_cast<uint32_t>(all[at + 3]) << 24);
  };
  size_t at = 0;
  while (at + 17 <= all.size()) {
    const int lossless = all[at];
    const int width = static_cast<int>(le32(at + 1)), height = static_cast<int>(le32(at + 5));
    const uint32_t size = le32(at + 9), alpha_size = le32(at + 13);
    at += 17;
    const bool has_alpha = alpha_size != 0xffffffffu;
    const size_t total = size + (has_alpha ? alpha_size : 0);
    if (at + total > all.size()) return 3;
    // copies of their own, so a read past either buffer is caught
    std::vector<uint8_t> data(all.begin() + at, all.begin() + at + size);
    std::vector<uint8_t> alpha;
    if (has_alpha) alpha.assign(all.begin() + at + size, all.begin() + at + total);
    at += total;
    std::vector<uint8_t> rgba(static_cast<size_t>(width) * height * 4);
    const int rc = vtc_webp_decode(data.data(), data.size(), lossless,
                                   has_alpha ? alpha.data() : nullptr, alpha.size(), width,
                                   height, rgba.data());
    printf("%d\n", rc);
  }
  return 0;
}
#endif
