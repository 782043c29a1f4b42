// Native BPE merge engine for the GPT-2 tokenizer hot loop.
//
// The embedding/data pipeline tokenizes ~10^5..10^6 captions per corpus
// (reference train.py:88-101 caches this for a reason). Pre-tokenization
// (the \p{L}/\p{N} regex) stays in Python where exact Unicode semantics are
// free; the merge loop — the actual hot path — runs here.
//
// C ABI (ctypes):
//   void*  bpe_create(const char* merges_utf8, const char* vocab_entries)
//   void   bpe_destroy(void*)
//   long   bpe_encode_batch(void* h, const char* pretokens_nl,
//                           int32_t* out, long out_cap, int32_t* lengths,
//                           long max_items)
//
// `merges_utf8`: newline-separated "A B" merge pairs in rank order.
// `vocab_entries`: newline-separated "TOKEN\tID" entries.
// `pretokens_nl`: newline-separated byte-mapped pretokens (the GPT-2
// byte→unicode mapping guarantees no raw control characters appear).
// Returns total token count, or -1 on overflow / -2 on unknown symbol.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003u ^ h(p.second);
  }
};

struct Bpe {
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::string, std::vector<int32_t>> cache;
};

// Split a UTF-8 string into codepoint-level chunks.
void utf8_chars(const std::string& s, std::vector<std::string>* out) {
  out->clear();
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    size_t len = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
    if (i + len > s.size()) len = 1;
    out->push_back(s.substr(i, len));
    i += len;
  }
}

bool bpe_token(Bpe* bpe, const std::string& token,
               std::vector<int32_t>* out) {
  auto cached = bpe->cache.find(token);
  if (cached != bpe->cache.end()) {
    out->insert(out->end(), cached->second.begin(), cached->second.end());
    return true;
  }
  std::vector<std::string> word;
  utf8_chars(token, &word);
  if (word.empty()) return true;
  while (word.size() > 1) {
    // find the lowest-rank adjacent pair
    int best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      auto it = bpe->ranks.find({word[i], word[i + 1]});
      if (it != bpe->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge ALL occurrences of that pair left-to-right
    const std::string first = word[best_i];
    const std::string second = word[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(word.size());
    size_t i = 0;
    while (i < word.size()) {
      if (i + 1 < word.size() && word[i] == first && word[i + 1] == second) {
        merged.push_back(first + second);
        i += 2;
      } else {
        merged.push_back(word[i]);
        i += 1;
      }
    }
    word.swap(merged);
  }
  std::vector<int32_t> ids;
  ids.reserve(word.size());
  for (const auto& piece : word) {
    auto it = bpe->vocab.find(piece);
    if (it == bpe->vocab.end()) return false;
    ids.push_back(it->second);
  }
  if (bpe->cache.size() < (1u << 20)) bpe->cache.emplace(token, ids);
  out->insert(out->end(), ids.begin(), ids.end());
  return true;
}

}  // namespace

extern "C" {

void* bpe_create(const char* merges_utf8, const char* vocab_entries) {
  auto* bpe = new Bpe();
  {
    const char* p = merges_utf8;
    int rank = 0;
    while (*p) {
      const char* nl = strchr(p, '\n');
      size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
      std::string line(p, len);
      size_t sp = line.find(' ');
      if (sp != std::string::npos) {
        bpe->ranks[{line.substr(0, sp), line.substr(sp + 1)}] = rank++;
      }
      p += len + (nl ? 1 : 0);
    }
  }
  {
    const char* p = vocab_entries;
    while (*p) {
      const char* nl = strchr(p, '\n');
      size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
      std::string line(p, len);
      size_t tab = line.rfind('\t');
      if (tab != std::string::npos) {
        bpe->vocab[line.substr(0, tab)] =
            static_cast<int32_t>(atoi(line.c_str() + tab + 1));
      }
      p += len + (nl ? 1 : 0);
    }
  }
  return bpe;
}

void bpe_destroy(void* h) { delete static_cast<Bpe*>(h); }

long bpe_encode_batch(void* h, const char* pretokens_nl, int32_t* out,
                      long out_cap, int32_t* lengths, long max_items) {
  auto* bpe = static_cast<Bpe*>(h);
  std::vector<int32_t> ids;
  long item = 0;
  const char* p = pretokens_nl;
  while (*p && item < max_items) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
    std::string token(p, len);
    size_t before = ids.size();
    if (!bpe_token(bpe, token, &ids)) return -2;
    lengths[item++] = static_cast<int32_t>(ids.size() - before);
    p += len + (nl ? 1 : 0);
  }
  if (static_cast<long>(ids.size()) > out_cap) return -1;
  memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<long>(ids.size());
}

}  // extern "C"
