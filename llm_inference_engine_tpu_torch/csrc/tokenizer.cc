// Native BPE tokenizer: trie-matched vocab lookup + score-ordered heap
// merges (SentencePiece semantics). This is the C++ equivalent of the
// reference engine's hand-rolled tokenizer (reference:
// src/models/tokenizer.h:57-348 — a TrieNode vocab index at tokenizer.h:57-135
// feeding a priority-queue merge loop at tokenizer.h:168-271, with byte
// fallback at tokenizer.h:282-289). The algorithm is specified by — and
// tested for exact parity against — the pure-Python fallback in
// llm_inference_engine_tpu_torch/tokenizer/bpe.py (a copy of the JAX
// package's tokenizer/bpe.py).
//
// Exposed as a C ABI consumed via ctypes (tokenizer/native.py). Encoding is
// the per-request host hot path of an inference server; everything here is
// O(n log n) in symbols with no Python-object overhead.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Piece {
  int32_t id;
  float score;
};

// Trie over piece bytes: O(len) exact lookup during merge candidate checks
// and byte-fallback segmentation (mirrors the reference's TrieNode index,
// tokenizer.h:57-135, without per-node heap allocation churn).
struct TrieNode {
  int32_t piece = -1;  // index into pieces_ when a piece ends here
  std::unordered_map<uint8_t, int32_t> next;
};

struct Tokenizer {
  std::vector<std::string> piece_str;
  std::vector<Piece> piece_meta;
  std::vector<TrieNode> trie{TrieNode{}};
  std::unordered_map<std::string, int32_t> exact;  // piece -> index
  // id -> piece index (dense where possible)
  std::vector<int32_t> id_to_piece;
  int32_t byte_ids[256];
  int32_t bos_id = 1, eos_id = 2, unk_id = 0;
  bool add_leading_blank = true;

  Tokenizer() { std::memset(byte_ids, 0xFF, sizeof(byte_ids)); }

  int32_t Find(const std::string& s) const {
    auto it = exact.find(s);
    return it == exact.end() ? -1 : it->second;
  }

  void Add(const char* bytes, int len, int32_t id, float score) {
    std::string s(bytes, len);
    int32_t idx = static_cast<int32_t>(piece_str.size());
    piece_str.push_back(s);
    piece_meta.push_back({id, score});
    exact.emplace(s, idx);
    // trie insert
    int32_t node = 0;
    for (int i = 0; i < len; ++i) {
      uint8_t b = static_cast<uint8_t>(bytes[i]);
      auto it = trie[node].next.find(b);
      if (it == trie[node].next.end()) {
        trie.push_back(TrieNode{});
        int32_t nn = static_cast<int32_t>(trie.size()) - 1;
        trie[node].next.emplace(b, nn);
        node = nn;
      } else {
        node = it->second;
      }
    }
    trie[node].piece = idx;
    // byte-fallback piece "<0xAB>"
    if (len == 6 && s[0] == '<' && s[1] == '0' && s[2] == 'x' && s[5] == '>') {
      auto hex = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        return -1;
      };
      int hi = hex(s[3]), lo = hex(s[4]);
      if (hi >= 0 && lo >= 0) byte_ids[hi * 16 + lo] = id;
    }
    if (id >= 0) {
      if (static_cast<size_t>(id) >= id_to_piece.size())
        id_to_piece.resize(id + 1, -1);
      id_to_piece[id] = idx;
    }
  }
};

// UTF-8 char length from the lead byte (invalid lead bytes -> 1).
inline int U8Len(uint8_t b) {
  if (b < 0x80) return 1;
  if ((b >> 5) == 0x6) return 2;
  if ((b >> 4) == 0xE) return 3;
  if ((b >> 3) == 0x1E) return 4;
  return 1;
}

struct Cand {
  float score;
  int64_t order;  // insertion order: tie-break = earliest pushed
  int32_t left, right;
  int32_t piece_idx;
  int32_t merged_len;
  bool operator<(const Cand& o) const {  // max-heap by score, then FIFO
    if (score != o.score) return score < o.score;
    return order > o.order;
  }
};

}  // namespace

extern "C" {

void* llm_tok_new(int32_t bos_id, int32_t eos_id, int32_t unk_id,
                  int32_t add_leading_blank) {
  auto* t = new Tokenizer();
  t->bos_id = bos_id;
  t->eos_id = eos_id;
  t->unk_id = unk_id;
  t->add_leading_blank = add_leading_blank != 0;
  return t;
}

void llm_tok_free(void* h) { delete static_cast<Tokenizer*>(h); }

void llm_tok_add_piece(void* h, const char* bytes, int32_t len, int32_t id,
                       float score) {
  static_cast<Tokenizer*>(h)->Add(bytes, len, id, score);
}

// Encode UTF-8 `text` into `out` (caller-allocated, cap `max_out`).
// Returns the number of ids written, or -needed if max_out was too small.
// Mirrors bpe.py BPETokenizer.encode exactly: blank substitution, initial
// per-character symbols, score-ordered lazily-invalidated heap merges,
// byte fallback for unmatched leftovers.
int32_t llm_tok_encode(void* h, const char* text, int32_t text_len,
                       int32_t add_bos, int32_t add_eos, int32_t* out,
                       int32_t max_out) {
  const auto& t = *static_cast<Tokenizer*>(h);
  static const char kBlank[] = "\xe2\x96\x81";  // U+2581

  // " " -> "▁"; optional leading "▁"
  std::string s;
  s.reserve(text_len + 8);
  bool starts_blank =
      text_len >= 3 && std::memcmp(text, kBlank, 3) == 0;
  if (t.add_leading_blank && !(text_len > 0 && text[0] == ' ') &&
      !starts_blank)
    s.append(kBlank, 3);
  for (int i = 0; i < text_len; ++i) {
    if (text[i] == ' ')
      s.append(kBlank, 3);
    else
      s.push_back(text[i]);
  }

  // initial symbols: UTF-8 characters as (offset, len) into s
  struct Sym {
    int32_t off, len;
    int32_t prev, next;
    bool alive;
  };
  std::vector<Sym> syms;
  syms.reserve(s.size());
  for (size_t i = 0; i < s.size();) {
    int l = U8Len(static_cast<uint8_t>(s[i]));
    if (i + l > s.size()) l = 1;
    syms.push_back({static_cast<int32_t>(i), l, 0, 0, true});
    i += l;
  }
  int n = static_cast<int32_t>(syms.size());
  for (int i = 0; i < n; ++i) {
    syms[i].prev = i - 1;
    syms[i].next = i + 1;
  }

  std::priority_queue<Cand> heap;
  int64_t counter = 0;
  std::string buf;
  auto push = [&](int32_t l, int32_t r) {
    if (l < 0 || r >= n) return;
    buf.assign(s, syms[l].off, syms[l].len);
    buf.append(s, syms[r].off, syms[r].len);
    int32_t idx = t.Find(buf);
    if (idx < 0) return;
    heap.push({t.piece_meta[idx].score, counter++, l, r, idx,
               syms[l].len + syms[r].len});
  };
  for (int i = 1; i < n; ++i) push(i - 1, i);

  while (!heap.empty()) {
    Cand c = heap.top();
    heap.pop();
    if (!syms[c.left].alive || !syms[c.right].alive) continue;
    // stale if either side was merged since push (length changed or no
    // longer adjacent)
    if (syms[c.left].next != c.right ||
        syms[c.left].len + syms[c.right].len != c.merged_len)
      continue;
    syms[c.left].len += syms[c.right].len;  // contiguous in s by construction
    syms[c.right].alive = false;
    syms[c.left].next = syms[c.right].next;
    if (syms[c.right].next < n) syms[syms[c.right].next].prev = c.left;
    if (syms[c.left].prev >= 0) push(syms[c.left].prev, c.left);
    if (syms[c.left].next < n) push(c.left, syms[c.left].next);
  }

  int32_t count = 0;
  auto emit = [&](int32_t id) {
    if (count < max_out) out[count] = id;
    ++count;
  };
  if (add_bos && t.bos_id >= 0) emit(t.bos_id);
  for (int i = 0; i < n && i >= 0; i = syms[i].next) {
    if (!syms[i].alive) continue;
    buf.assign(s, syms[i].off, syms[i].len);
    int32_t idx = t.Find(buf);
    if (idx >= 0) {
      emit(t.piece_meta[idx].id);
    } else {
      for (int j = 0; j < syms[i].len; ++j) {
        uint8_t b = static_cast<uint8_t>(s[syms[i].off + j]);
        emit(t.byte_ids[b] >= 0 ? t.byte_ids[b] : t.unk_id);
      }
    }
  }
  if (add_eos && t.eos_id >= 0) emit(t.eos_id);
  return count <= max_out ? count : -count;
}

// Decode `ids` into `out` UTF-8 bytes (cap max_out). Returns bytes written
// or -needed. Byte pieces are emitted raw; "▁" -> " "; specials <s>/</s>/
// <unk> skipped; <n>, <|tab|>, <|blank_N|> expanded (tokenizer.h:305-347).
// The leading blank (if configured) is stripped by the Python wrapper,
// which owns string semantics.
int32_t llm_tok_decode(void* h, const int32_t* ids, int32_t n_ids, char* out,
                       int32_t max_out) {
  const auto& t = *static_cast<Tokenizer*>(h);
  std::string res;
  res.reserve(n_ids * 4);
  for (int i = 0; i < n_ids; ++i) {
    int32_t id = ids[i];
    int32_t idx = (id >= 0 && static_cast<size_t>(id) < t.id_to_piece.size())
                      ? t.id_to_piece[id]
                      : -1;
    if (idx < 0) continue;
    const std::string& p = t.piece_str[idx];
    if (p.size() == 6 && p[0] == '<' && p[1] == '0' && p[2] == 'x' &&
        p[5] == '>') {
      // byte piece: recover the byte value
      auto hex = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        return -1;
      };
      int hi = hex(p[3]), lo = hex(p[4]);
      if (hi >= 0 && lo >= 0) {
        res.push_back(static_cast<char>(hi * 16 + lo));
        continue;
      }
    }
    if (p == "<s>" || p == "</s>" || p == "<unk>") continue;
    if (p == "<n>") {
      res.push_back('\n');
      continue;
    }
    if (p == "<|tab|>") {
      res.push_back('\t');
      continue;
    }
    if (p.size() > 10 && p.rfind("<|blank_", 0) == 0 &&
        p.compare(p.size() - 2, 2, "|>") == 0) {
      int k = atoi(p.substr(8, p.size() - 10).c_str());
      res.append(k, ' ');
      continue;
    }
    // "▁" -> " "
    size_t pos = 0;
    while (pos < p.size()) {
      if (pos + 3 <= p.size() && std::memcmp(p.data() + pos, "\xe2\x96\x81", 3) == 0) {
        res.push_back(' ');
        pos += 3;
      } else {
        res.push_back(p[pos]);
        ++pos;
      }
    }
  }
  int32_t nres = static_cast<int32_t>(res.size());
  if (nres <= max_out) {
    std::memcpy(out, res.data(), nres);
    return nres;
  }
  return -nres;
}

}  // extern "C"
