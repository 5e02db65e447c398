// Native host-side protein tokenizer + padded batch assembler.
//
// Tokenization and batch collation run on the host (BASELINE.json); at
// production batch sizes the Python tokenizer becomes a host bottleneck
// between device steps. This C library tokenizes the ESM 33-symbol alphabet
// (fair-esm ordering, matching data/protein.py) and assembles padded (ids,
// mask) batches in one pass, exposed through ctypes (native/bindings.py
// builds it with g++ on first use; no pybind11, no PyTorch headers).
//
// Layout contract (must match data/protein.py):
//   0=<cls> 1=<pad> 2=<eos> 3=<unk>, residues L..C at 4..23, X=24, B=25,
//   U=26, Z=27, O=28, '.'=29, '-'=30, <null_1>=31, <mask>=32.

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr int32_t CLS = 0, PAD = 1, EOS = 2, UNK = 3;

// byte -> token id lookup (256 entries), built once
struct Lut {
  int32_t table[256];
  Lut() {
    for (int i = 0; i < 256; ++i) table[i] = UNK;
    const char* residues = "LAGVSERTIDPKQNFYMHWC";  // ids 4..23
    for (int i = 0; i < 20; ++i) {
      table[(unsigned char)residues[i]] = 4 + i;
      table[(unsigned char)(residues[i] + 32)] = 4 + i;  // lowercase
    }
    table[(unsigned char)'X'] = 24; table[(unsigned char)'x'] = 24;
    table[(unsigned char)'B'] = 25; table[(unsigned char)'b'] = 25;
    table[(unsigned char)'U'] = 26; table[(unsigned char)'u'] = 26;
    table[(unsigned char)'Z'] = 27; table[(unsigned char)'z'] = 27;
    table[(unsigned char)'O'] = 28; table[(unsigned char)'o'] = 28;
    table[(unsigned char)'.'] = 29;
    table[(unsigned char)'-'] = 30;
  }
};
const Lut kLut;

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

}  // namespace

extern "C" {

// Tokenize one sequence into out[0..max_len); returns the token count.
// replace_uzob: map U/Z/O/B -> X (ProtT5 convention, old/encoders.py:20-21).
int32_t tokenize_one(const char* seq, int32_t seq_len, int32_t* out,
                     int32_t max_len, int32_t add_special,
                     int32_t replace_uzob) {
  int32_t n = 0;
  int32_t budget = add_special ? max_len - 2 : max_len;
  if (add_special) out[n++] = CLS;
  for (int32_t i = 0; i < seq_len && budget > 0; ++i) {
    unsigned char c = (unsigned char)seq[i];
    if (is_space(c)) continue;
    int32_t id = kLut.table[c];
    if (replace_uzob && id >= 25 && id <= 28) id = 24;  // BUZO -> X
    out[n++] = id;
    --budget;
  }
  if (add_special) out[n++] = EOS;
  return n;
}

// Batch tokenize + pad: sequences are concatenated in `data` with
// per-sequence lengths in `lengths` (batch entries). Writes
// ids (batch, padded_len) int32 and mask (batch, padded_len) uint8.
// padded_len is computed by the caller (max tokenized length rounded up);
// returns the required padded length for the batch (<= max_len, multiple of
// pad_multiple) so callers can size buffers with a first pass when desired.
int32_t tokenize_batch(const char* data, const int64_t* offsets,
                       int32_t batch, int32_t max_len, int32_t pad_multiple,
                       int32_t replace_uzob, int32_t* ids, uint8_t* mask,
                       int32_t padded_len) {
  int32_t longest = 0;
  for (int32_t b = 0; b < batch; ++b) {
    const char* seq = data + offsets[b];
    int32_t seq_len = (int32_t)(offsets[b + 1] - offsets[b]);
    int32_t* row = ids + (int64_t)b * padded_len;
    uint8_t* mrow = mask + (int64_t)b * padded_len;
    int32_t n = tokenize_one(seq, seq_len, row, std::min(max_len, padded_len),
                             /*add_special=*/1, replace_uzob);
    longest = std::max(longest, n);
    for (int32_t j = 0; j < n; ++j) mrow[j] = 1;
    for (int32_t j = n; j < padded_len; ++j) { row[j] = PAD; mrow[j] = 0; }
  }
  int32_t padded = ((longest + pad_multiple - 1) / pad_multiple) * pad_multiple;
  return std::min(padded, padded_len);
}

// Gather + pad float32 token-embedding sequences (the RNA/RBP collation of
// data/collate.py::pad_token_batch) in one native pass:
// src: concatenated rows (total_tokens, dim); lengths per sequence.
void pad_embedding_batch(const float* src, const int64_t* offsets,
                         int32_t batch, int32_t dim, int32_t padded_len,
                         float* out, uint8_t* mask) {
  for (int32_t b = 0; b < batch; ++b) {
    int64_t start = offsets[b];
    int32_t len = (int32_t)(offsets[b + 1] - start);
    if (len > padded_len) len = padded_len;
    float* orow = out + (int64_t)b * padded_len * dim;
    uint8_t* mrow = mask + (int64_t)b * padded_len;
    std::memcpy(orow, src + start * dim, (size_t)len * dim * sizeof(float));
    std::memset(orow + (int64_t)len * dim, 0,
                (size_t)(padded_len - len) * dim * sizeof(float));
    std::memset(mrow, 1, len);
    std::memset(mrow + len, 0, padded_len - len);
  }
}

}  // extern "C"
