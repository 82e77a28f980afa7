// aspire_text: native tokenization core for the aspire_tpu_torch data pipeline
// (the port's own copy of the JAX package's native/aspire_text.cpp).
//
// The reference retokenizes every training example with the Python HF
// tokenizer on every epoch (src/learning/batchers.py:61-252) -- the CPU-side
// hot loop of training.  This library implements the BERT BasicTokenizer +
// WordPiece pipeline (greedy longest-match-first with "##" continuations)
// with a C ABI consumed via ctypes (no pybind11 in this image).
//
// Unicode semantics follow HF BasicTokenizer
// (transformers/models/bert/tokenization_bert.py) using generated BMP
// property tables (aspire_unicode_tables.h, from gen_unicode_tables.py):
//   clean text (drop Cc/Cf, U+0000, U+FFFD; unicode spaces split), CJK
//   ideograph spacing, per-token lowercase + NFD accent strip (incl. the
//   Final_Sigma rule), unicode punctuation splitting.
// Documented deviation: codepoints above the BMP are opaque letters (no
// supplementary-plane casing/punctuation -- absent from scientific text).
//
// Build: text/fast.py runs g++ -O3 -std=c++17 -shared -fPIC aspire_text.cpp
// at first use, into build/aspire_tpu_torch/ beside the package.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <fstream>

#include "aspire_unicode_tables.h"

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> token2id;
    int32_t unk_id = 0;
    int32_t max_chars_per_word = 100;
};

inline bool bit(const uint32_t* bits, uint32_t cp) {
    return cp < 0x10000 && ((bits[cp >> 5] >> (cp & 31)) & 1u);
}
inline bool u_is_punct(uint32_t cp)   { return bit(kPunctBits, cp); }
inline bool u_is_space(uint32_t cp)   { return bit(kSpaceBits, cp); }
inline bool u_is_control(uint32_t cp) { return bit(kControlBits, cp); }
inline bool u_is_cased(uint32_t cp)   { return bit(kCasedBits, cp); }
inline bool u_is_mark(uint32_t cp)    { return bit(kMarkBits, cp); }

// HF _is_chinese_char ranges (CJK ideographs; NOT kana/hangul).
inline bool u_is_cjk(uint32_t cp) {
    return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
           (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
           (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
           (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

// Decode one UTF-8 codepoint; returns bytes consumed (>=1).  Invalid bytes
// decode to U+FFFD, which the cleaner drops (HF drops it too).
inline size_t utf8_decode(const unsigned char* p, uint32_t* cp) {
    unsigned char c = p[0];
    if (c < 0x80) { *cp = c; return 1; }
    if ((c & 0xE0) == 0xC0 && (p[1] & 0xC0) == 0x80) {
        *cp = ((c & 0x1Fu) << 6) | (p[1] & 0x3Fu);
        return 2;
    }
    if ((c & 0xF0) == 0xE0 && (p[1] & 0xC0) == 0x80 && (p[2] & 0xC0) == 0x80) {
        *cp = ((c & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) | (p[2] & 0x3Fu);
        return 3;
    }
    if ((c & 0xF8) == 0xF0 && (p[1] & 0xC0) == 0x80 && (p[2] & 0xC0) == 0x80 &&
        (p[3] & 0xC0) == 0x80) {
        *cp = ((c & 0x07u) << 18) | ((p[1] & 0x3Fu) << 12) |
              ((p[2] & 0x3Fu) << 6) | (p[3] & 0x3Fu);
        return 4;
    }
    *cp = 0xFFFD;
    return 1;
}

inline void append_utf8(std::string* s, uint32_t cp) {
    if (cp < 0x80) {
        s->push_back((char)cp);
    } else if (cp < 0x800) {
        s->push_back((char)(0xC0 | (cp >> 6)));
        s->push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        s->push_back((char)(0xE0 | (cp >> 12)));
        s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        s->push_back((char)(0x80 | (cp & 0x3F)));
    } else {
        s->push_back((char)(0xF0 | (cp >> 18)));
        s->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
        s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        s->push_back((char)(0x80 | (cp & 0x3F)));
    }
}

// fold(cp) = strip_accents(lower(cp)); identity when absent from the table.
// Appends the folded codepoints to out.
inline void fold_append(uint32_t cp, std::vector<uint32_t>* out) {
    uint32_t lo = 0, hi = kFoldCount;
    while (lo < hi) {
        uint32_t mid = (lo + hi) / 2;
        if (kFold[mid].cp < cp) lo = mid + 1; else hi = mid;
    }
    if (lo < kFoldCount && kFold[lo].cp == cp) {
        const unsigned char* p = kFoldPool + kFold[lo].offset;
        const unsigned char* end = p + kFold[lo].len;
        while (p < end) {
            uint32_t f;
            p += utf8_decode(p, &f);
            out->push_back(f);
        }
        return;  // len 0 (Mn mark) appends nothing
    }
    out->push_back(cp);
}

// HF BasicTokenizer: clean -> CJK spacing -> whitespace split -> per token
// (lowercase + strip accents) -> punctuation split.
//
// Lowercasing is PER CODEPOINT, context-free: PreTrainedTokenizer.tokenize
// pre-lowercases the raw text one character at a time (the `(.+?)` regex in
// tokenization_utils.py), so Python's Final_Sigma context rule never fires
// and U+03A3 always folds to U+03C3 -- the fold table already encodes this.
void basic_tokenize(const char* text, bool lowercase,
                    std::vector<std::string>* words) {
    std::vector<std::vector<uint32_t>> toks;
    std::vector<uint32_t> cur;
    const unsigned char* p = (const unsigned char*)text;
    while (*p) {
        uint32_t cp;
        p += utf8_decode(p, &cp);
        if (cp == 0 || cp == 0xFFFD || u_is_control(cp)) continue;
        if (u_is_space(cp)) {
            if (!cur.empty()) { toks.push_back(cur); cur.clear(); }
        } else if (u_is_cjk(cp)) {
            if (!cur.empty()) { toks.push_back(cur); cur.clear(); }
            toks.push_back({cp});
        } else {
            cur.push_back(cp);
        }
    }
    if (!cur.empty()) toks.push_back(cur);

    std::string word;
    for (const auto& tok : toks) {
        std::vector<uint32_t> folded;
        folded.reserve(tok.size());
        if (lowercase) {
            for (size_t i = 0; i < tok.size(); ++i) {
                fold_append(tok[i], &folded);
            }
        } else {
            folded = tok;
        }
        word.clear();
        for (uint32_t cp : folded) {
            if (u_is_punct(cp)) {
                if (!word.empty()) { words->push_back(word); word.clear(); }
                std::string pw;
                append_utf8(&pw, cp);
                words->push_back(pw);
            } else {
                append_utf8(&word, cp);
            }
        }
        if (!word.empty()) { words->push_back(word); word.clear(); }
    }
}

// Count UTF-8 codepoints (HF caps words at max_chars_per_word CODEPOINTS).
size_t utf8_len(const std::string& s) {
    size_t n = 0;
    for (unsigned char c : s) if ((c & 0xC0) != 0x80) ++n;
    return n;
}

// Greedy longest-match-first WordPiece on one word.
void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int32_t>* out) {
    if (utf8_len(word) > (size_t)v.max_chars_per_word) {
        out->push_back(v.unk_id);
        return;
    }
    std::vector<int32_t> pieces;
    size_t start = 0;
    while (start < word.size()) {
        size_t end = word.size();
        int32_t cur_id = -1;
        while (start < end) {
            std::string sub = word.substr(start, end - start);
            if (start > 0) sub = "##" + sub;
            auto it = v.token2id.find(sub);
            if (it != v.token2id.end()) { cur_id = it->second; break; }
            // back off one full UTF-8 codepoint
            do { --end; } while (end > start && (word[end] & 0xC0) == 0x80);
        }
        if (cur_id < 0) {  // no piece matched -> whole word is UNK
            out->push_back(v.unk_id);
            return;
        }
        pieces.push_back(cur_id);
        start = end;
    }
    out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* at_load_vocab(const char* path, const char* unk_token) {
    std::ifstream f(path);
    if (!f.good()) return nullptr;
    auto* v = new Vocab();
    std::string line;
    int32_t idx = 0;
    while (std::getline(f, line)) {
        // strip trailing \r
        while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
            line.pop_back();
        v->token2id.emplace(line, idx++);
    }
    auto it = v->token2id.find(unk_token ? unk_token : "[UNK]");
    v->unk_id = (it != v->token2id.end()) ? it->second : 0;
    return v;
}

void at_free_vocab(void* vocab) { delete (Vocab*)vocab; }

int32_t at_vocab_size(void* vocab) {
    return (int32_t)((Vocab*)vocab)->token2id.size();
}

int32_t at_token_id(void* vocab, const char* token) {
    auto& v = *(Vocab*)vocab;
    auto it = v.token2id.find(token);
    return it != v.token2id.end() ? it->second : -1;
}

// Tokenize one text. Returns number of ids written (<= max_out; truncates).
int32_t at_tokenize(void* vocab, const char* text, int32_t lowercase,
                    int32_t* out_ids, int32_t max_out) {
    auto& v = *(Vocab*)vocab;
    std::vector<std::string> words;
    basic_tokenize(text, lowercase != 0, &words);
    std::vector<int32_t> ids;
    ids.reserve(64);
    for (const auto& w : words) wordpiece(v, w, &ids);
    int32_t n = (int32_t)ids.size();
    if (n > max_out) n = max_out;
    std::memcpy(out_ids, ids.data(), n * sizeof(int32_t));
    return n;
}

// Tokenize a batch of texts (concatenated, NUL-separated) into a flat id
// buffer with per-text counts.  texts: n_texts NUL-terminated strings placed
// back to back.  Returns total ids written.
int32_t at_tokenize_batch(void* vocab, const char* texts, int32_t n_texts,
                          int32_t lowercase, int32_t* out_ids,
                          int32_t* out_counts, int32_t max_total) {
    const char* p = texts;
    int32_t total = 0;
    for (int32_t i = 0; i < n_texts; ++i) {
        int32_t n = at_tokenize(vocab, p, lowercase, out_ids + total,
                                max_total - total);
        out_counts[i] = n;
        total += n;
        p += std::strlen(p) + 1;
    }
    return total;
}

// Pack one document's sentence token streams into the model's flat arrays,
// applying the 500-token truncate-final-sentence rule and the +1 CLS offset
// (reference contract, ex_aspire_consent.py:107-181).
//
// sent_ids_flat/sent_counts: concatenated per-sentence token ids (title is
// sentence 0).  Outputs:
//   out_tokens: [CLS] + kept ids + [SEP]   (returns its length)
//   out_sent_labels: same length; -1 for CLS/SEP/title, else sentence index
//   *out_num_sents: number of kept abstract sentences (title excluded)
int32_t at_pack_doc(const int32_t* sent_ids_flat, const int32_t* sent_counts,
                    int32_t n_sents, int32_t max_num_toks,
                    int32_t cls_id, int32_t sep_id,
                    int32_t* out_tokens, int32_t* out_sent_labels,
                    int32_t* out_num_sents) {
    int32_t cur_len = 0;   // content tokens kept so far
    int32_t kept_sents = 0;
    out_tokens[0] = cls_id;
    out_sent_labels[0] = -1;
    int32_t w = 1;
    const int32_t* src = sent_ids_flat;
    for (int32_t s = 0; s < n_sents; ++s) {
        int32_t len = sent_counts[s];
        int32_t keep = len;
        bool last = false;
        if (cur_len + len > max_num_toks) {
            keep = max_num_toks - cur_len;
            last = true;
        }
        if (keep > 0) {
            for (int32_t i = 0; i < keep; ++i) {
                out_tokens[w] = src[i];
                out_sent_labels[w] = (s == 0) ? -1 : (s - 1);
                ++w;
            }
            cur_len += keep;
        }
        // the HF path appends a (possibly EMPTY) slot for every sentence
        // until the truncation break: a zero-token sentence still occupies
        // a slot, so later sentences keep their original indices and the
        // label/extraction bookkeeping stays aligned.  Only the sentence
        // that overflows with nothing kept is dropped.
        if ((!last || keep > 0) && s > 0) ++kept_sents;
        src += len;
        if (last) break;
    }
    out_tokens[w] = sep_id;
    out_sent_labels[w] = -1;
    ++w;
    *out_num_sents = kept_sents;
    return w;
}

}  // extern "C"
