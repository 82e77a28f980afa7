#!/usr/bin/env python
"""Generate aspire_unicode_tables.h for the native tokenizer.

Emits compact BMP (U+0000..U+FFFF) tables derived from Python's unicodedata
so the C++ BasicTokenizer reproduces HF's unicode semantics
(transformers.models.bert.tokenization_bert.BasicTokenizer):

  * kPunct / kSpace / kControl / kCased bitsets
      punct   = ASCII punct ranges OR category P*
      space   = ' ', \t, \n, \r, Zs (plus Zl/Zp, which python str.split
                treats as whitespace after _clean_text)
      control = Cc/Cf minus \t\n\r
      cased   = Lu/Ll/Lt (for the Final_Sigma lowercase rule)
  * fold table: cp -> UTF-8 string of strip_accents(lower(cp)) where that
    differs from identity; len 0 means the codepoint is deleted (Mn mark).
    HF lowers the token then NFD-normalizes and drops Mn; per-codepoint
    folding is equivalent because deleted marks make canonical reordering
    irrelevant.  The context-dependent sigma (U+03A3) is special-cased in
    C++ and folds here to plain sigma.

Codepoints above the BMP are treated as opaque letters by the C++ side
(supplementary-plane punctuation/casing never occurs in scientific text) --
documented deviation in PARITY.md.

Run: python aspire_tpu_torch/native/gen_unicode_tables.py \
       > aspire_tpu_torch/native/aspire_unicode_tables.h
"""
import sys
import unicodedata

BMP = 0x10000


def is_ascii_punct(cp: int) -> bool:
    return (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
           (123 <= cp <= 126)


def bitset(name: str, pred) -> str:
    words = []
    for base in range(0, BMP, 32):
        w = 0
        for k in range(32):
            if pred(base + k):
                w |= 1 << k
        words.append(w)
    body = ",".join(f"0x{w:08x}" for w in words)
    return (f"static const uint32_t {name}[{BMP // 32}] = {{{body}}};\n")


def fold(cp: int) -> str:
    """strip_accents(lower(chr(cp))): the per-codepoint fold."""
    ch = chr(cp)
    lowered = ch.lower()
    out = []
    for c in unicodedata.normalize("NFD", lowered):
        if unicodedata.category(c) != "Mn":
            out.append(c)
    return "".join(out)


def main():
    w = sys.stdout.write
    w("// GENERATED by gen_unicode_tables.py -- do not edit.\n")
    w(f"// python {sys.version.split()[0]}, unicodedata "
      f"{unicodedata.unidata_version}\n")
    w("#pragma once\n#include <cstdint>\n\n")

    cat = [unicodedata.category(chr(cp)) for cp in range(BMP)]
    w(bitset("kPunctBits", lambda cp: cp < BMP and (
        is_ascii_punct(cp) or cat[cp].startswith("P"))))
    w(bitset("kSpaceBits", lambda cp: cp < BMP and (
        cp in (0x20, 0x09, 0x0A, 0x0D) or cat[cp] in ("Zs", "Zl", "Zp"))))
    w(bitset("kControlBits", lambda cp: cp < BMP and (
        cp not in (0x09, 0x0A, 0x0D) and cat[cp] in ("Cc", "Cf"))))
    w(bitset("kCasedBits", lambda cp: cp < BMP and cat[cp] in
             ("Lu", "Ll", "Lt")))
    w(bitset("kMarkBits", lambda cp: cp < BMP and cat[cp] in
             ("Mn", "Mc", "Me")))

    # fold entries where fold(cp) != chr(cp); final sigma folds like sigma
    pool = bytearray()
    entries = []
    for cp in range(BMP):
        f = fold(cp)
        if f == chr(cp):
            continue
        data = f.encode("utf-8")
        entries.append((cp, len(pool), len(data)))
        pool.extend(data)
    assert len(pool) < (1 << 24)
    w(f"\nstruct FoldEntry {{ uint32_t cp; uint32_t offset; "
      f"uint8_t len; }};\n")
    w(f"static const FoldEntry kFold[{len(entries)}] = {{\n")
    for cp, off, ln in entries:
        w(f"  {{0x{cp:04x},{off},{ln}}},\n")
    w("};\n")
    w(f"static const uint32_t kFoldCount = {len(entries)};\n")
    body = ",".join(str(b) for b in pool)
    w(f"static const unsigned char kFoldPool[{len(pool)}] = {{{body}}};\n")


if __name__ == "__main__":
    main()
